"""Train and eval steps of the port (``fvt_tpu/train/steps.py``).

:class:`TrainStep` is one optimizer step on one device: the train-time
input transform on the device (:func:`train_inputs`), forward in train
mode (dropout from the step's generator, BatchNorm on batch statistics
with the running ones updated, the frozen backbone's too), the task's
loss (mean cross-entropy over all B*T frames; for ``REGRESSION`` the CCC
loss of the first output against the continuous label,
``train/losses.py``), backward, optimizer update.  The frozen backbone
subtrees (prefix ``spatial``: the ArcFace, the VGGish) get no gradient
and are kept out of the optimizer, so weight decay cannot move them.  A
trainable parameter that the loss does not reach (the TCN and BatchNorm of a
modality that JMT and MT do not fuse) takes a zero gradient, so weight
decay and momentum move it as ``fvt_tpu``'s optax chain does
(``add_decayed_weights`` before the trace or Adam); ``torch.optim`` would
skip it.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fvt_tpu_torch import constants
from fvt_tpu_torch.data.transforms import (draw_crop_flip,
                                           train_video_transform)
from fvt_tpu_torch.train import optim
from fvt_tpu_torch.train.losses import ccc_loss

FROZEN_PREFIX = 'spatial'


def cross_entropy_frames(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all B*T frames: logits (B, T, C), labels (B, T)."""
    b, t, c = logits.shape
    return F.cross_entropy(logits.reshape(b * t, c),
                           labels.reshape(b * t).long())


def label_key(batch: Dict[str, Any]) -> str:
    """The single ``*continuous_label`` key of a batch."""
    keys = [k for k in batch if 'continuous_label' in k]
    if len(keys) != 1:
        raise ValueError(f'expected one label stream, got {keys}')
    return keys[0]


def split_frozen(model: nn.Module) -> Tuple[Dict[str, nn.Parameter],
                                            Dict[str, nn.Parameter]]:
    """(trainable, frozen) named parameters; frozen are those under the
    ``spatial`` prefix (the backbones)."""
    named = dict(model.named_parameters())
    trainable = {k: v for k, v in named.items()
                 if not k.startswith(FROZEN_PREFIX)}
    frozen = {k: v for k, v in named.items() if k.startswith(FROZEN_PREFIX)}
    return trainable, frozen


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; the default (None) is the card, and
    it is an error when there is none: the CPU is taken only when the
    caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: the port runs on the card '
                               "unless the caller passes device='cpu'")
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(device)


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def train_inputs(inputs: Dict[str, torch.Tensor],
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """``fvt_tpu``'s ``_device_transform(train=True)`` (``steps.py:24-43``):
    a raw uint8 (or int8) video gets the train group transform, its crop
    offsets and flips drawn from ``generator`` first; bfloat16 feature
    streams are widened to float32; the rest passes as it is."""
    out = dict(inputs)
    video = out.get(constants.VIDEO)
    if video is not None and video.dtype in (torch.uint8, torch.int8):
        out[constants.VIDEO] = train_video_transform(
            video, *draw_crop_flip(video.shape[0], generator))
    for k, v in out.items():
        if k != constants.VIDEO and v.dtype == torch.bfloat16:
            out[k] = v.float()
    return out


class TrainStep:
    """One optimizer step of ``model`` on ``device``.  ``hp`` are the
    standardized optimizer hyperparameters
    (:func:`fvt_tpu_torch.train.optim.standardize_opt_params`);
    ``task`` picks the loss; ``with_outputs`` makes a step return the
    train-mode forward's outputs beside the loss (the regression trainer
    records them); ``tcn_fused`` routes the TCN blocks through the fused
    train kernel, ``reference`` through its plain version."""

    def __init__(self, model: nn.Module, hp, device=None, *,
                 task: str = constants.CLASSIFICATION,
                 with_outputs: bool = False,
                 tcn_fused: bool = True, reference: bool = False):
        if task not in (constants.CLASSIFICATION, constants.REGRESSION):
            raise ValueError(f'unknown task {task!r}')
        self.task = task
        self.with_outputs = with_outputs
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        # what the forward calls: the model, or its DDP wrapper
        # (parallel/dp.py's DPTrainStep)
        self.net = self.model
        self.tcn_fused = tcn_fused
        self.reference = reference
        self.trainable, frozen = split_frozen(self.model)
        for p in frozen.values():
            p.requires_grad_(False)
        self.optimizer = optim.build_optimizer(hp, self.trainable.values())
        self.step = 0

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The train-mode forward (updates the BatchNorm running
        statistics) and its loss, for tensors already on the device:
        (loss, outputs)."""
        labels = batch[label_key(batch)]
        inputs = train_inputs({k: v for k, v in batch.items()
                               if 'continuous_label' not in k}, generator)
        out = self.net(inputs, True, generator, tcn_fused=self.tcn_fused,
                       reference=self.reference)
        if self.task == constants.REGRESSION:
            # in the outputs' type, as fvt_tpu casts: float64 in the
            # float64 lockstep tests
            return ccc_loss(labels.to(out.dtype), out[..., 0]), out
        return cross_entropy_frames(out, labels), out

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> torch.Tensor:
        """The loss of :meth:`forward`."""
        return self.forward(batch, generator)[0]

    def __call__(self, batch: Dict[str, Any], generator: torch.Generator):
        """Takes the step; returns the loss as a 0-d tensor on the device
        (no synchronisation), and with ``with_outputs`` the (B, T, C)
        outputs of the step's forward too, detached."""
        batch = to_device(batch, self.device)
        self.optimizer.zero_grad(set_to_none=True)
        loss, out = self.forward(batch, generator)
        loss.backward()
        for p in self.trainable.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.step += 1
        if self.with_outputs:
            return loss.detach(), out.detach()
        return loss.detach()


def eval_step(model: nn.Module, inputs: Dict[str, Any], device=None, *,
              reference: bool = False) -> torch.Tensor:
    """(B, T, C) logits of the eval forward (running-stat BatchNorm, no
    dropout, the eval kernels), without gradient."""
    device = resolve_device(device)
    with torch.inference_mode():
        return model(to_device(inputs, device), reference=reference)
