"""The training loop of the port, a first part of
``fvt_tpu/train/trainer.py``: epochs of optimizer steps over window
batches, the per-epoch learning-rate schedule and the finite-loss guard.
Validation, checkpoints, the store loaders and the CLIs are not ported
yet.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable

import numpy as np
import torch
from torch import nn

from fvt_tpu_torch import constants
from fvt_tpu_torch.train import optim
from fvt_tpu_torch.train.steps import TrainStep
from fvt_tpu_torch.utils import rng


class Trainer:
    """Trains ``model`` under ``config``, a dict with the keys of
    ``fvt_tpu/config/defaults.py`` (``seed``, ``num_epochs``,
    ``min_num_epochs``, ``nan_guard`` and the ``opt__*`` family).  Runs on
    the card unless ``device='cpu'`` is passed."""

    def __init__(self, model: nn.Module, config: Dict[str, Any],
                 device=None, *, tcn_fused: bool = True,
                 reference: bool = False):
        self.config = config
        self.hp = optim.standardize_opt_params(config)
        self.train_step = TrainStep(
            model, self.hp, device,
            task=config.get('task', constants.CLASSIFICATION),
            tcn_fused=tcn_fused, reference=reference)
        self.model = self.train_step.model
        self.device = self.train_step.device
        self.scheduler = optim.build_scheduler(
            self.hp, config['num_epochs'], config['min_num_epochs'])
        self.step_losses: list = []  # of the last epoch, one a step

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        return self.train_step.optimizer

    def step_generator(self, epoch: int, step: int) -> torch.Generator:
        """A generator on the trainer's device for the stream
        (seed, 'epoch<e>', step): a step repeats bit for bit from the same
        state, whatever ran before it."""
        return rng.generator(self.config['seed'], f'epoch{epoch}', step,
                             self.device)

    def train_one_epoch(self, batches: Iterable[Dict[str, np.ndarray]],
                        epoch: int) -> float:
        """One pass over ``batches`` of numpy windows ``{modality:
        (B, T, D) float32, '*continuous_label': (B, T) int}``; then the
        scheduler's lr for the next epoch.  Returns the mean loss.  The
        losses stay on the device until the epoch ends."""
        losses = [self.train_step(batch, self.step_generator(epoch, i))
                  for i, batch in enumerate(batches)]
        self.step_losses = losses = [float(l) for l in losses]
        if self.config.get('nan_guard', False):
            for i, l in enumerate(losses):
                if not math.isfinite(l):
                    raise FloatingPointError(
                        f'non-finite loss {l} at epoch {epoch} step {i} '
                        f'(lr={optim.get_lr(self.optimizer):.3e})')
        if self.scheduler is not None:
            optim.set_lr(self.optimizer, self.scheduler.lr(epoch + 1))
        return sum(losses) / max(len(losses), 1)
