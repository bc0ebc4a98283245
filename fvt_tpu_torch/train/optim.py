"""Optimizers and LR schedules of the port (``fvt_tpu/train/optim.py``).

``fvt_tpu`` re-implemented PyTorch's SGD and Adam on optax; here they are
``torch.optim.SGD`` / ``Adam`` themselves: L2 weight decay added to the
gradient, heavy-ball momentum with optional Nesterov, dampening with the
undamped first step, bias-corrected Adam moments, optional amsgrad.

The schedules are per EPOCH and stepped after each train epoch: STEP /
MULTISTEP / MYSTEP (min-lr-clamped step) / COSINE (CosineAnnealingLR
closed form) / MYCOSINE / MYWARMUP (warmup then plateau decay; stateful).
They are plain Python, copied from ``fvt_tpu`` and held equal to it by
``tests/test_torch_optim.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

import torch

from fvt_tpu_torch import constants

TORCH_DEFAULT_LR = 1e-3


def effective_base_lr(hp) -> float:
    """The base lr a run actually trains at.  The upstream project builds
    torch SGD/Adam without passing ``lr=``, so torch's default 1e-3
    applies and the configured ``opt__lr`` reaches neither the optimizer
    nor the epoch schedules; only MYWARMUP carries it.  Reproduced by
    default, as ``fvt_tpu`` does; ``opt__honor_lr=true`` is the opt-in
    that makes the optimizer and the schedules use the configured lr."""
    if getattr(hp, 'honor_lr', False):
        return hp.lr
    return TORCH_DEFAULT_LR


def build_optimizer(hp, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """hp: standardized opt hyperparams (attributes, not 'opt__' keys);
    params: the trainable parameters only."""
    name = hp.name_optimizer
    if name not in constants.OPTIMIZERS:
        raise ValueError(f'unknown optimizer {name!r}')
    lr = effective_base_lr(hp)
    if name == constants.SGD:
        if hp.nesterov and hp.dampening != 0.0:
            raise ValueError('torch SGD requires dampening=0 with nesterov')
        return torch.optim.SGD(params, lr=lr, momentum=hp.momentum,
                               dampening=hp.dampening,
                               weight_decay=hp.weight_decay,
                               nesterov=hp.nesterov)
    if name == constants.ADAM:
        return torch.optim.Adam(params, lr=lr, betas=(hp.beta1, hp.beta2),
                                eps=hp.eps_adam,
                                weight_decay=hp.weight_decay,
                                amsgrad=hp.amsgrad)
    raise NotImplementedError(name)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group['lr'] = lr


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]['lr'])


# ----------------------------------------------------------------- schedules
class Scheduler:
    """lr(epoch) interface; ``step(epoch, metric)`` returns the lr for the
    NEXT epoch (stepped after each epoch)."""

    def lr(self, epoch: int) -> float:
        raise NotImplementedError

    def step(self, epoch: int, metric: Optional[float] = None) -> float:
        return self.lr(epoch + 1)

    # stateless by default; MyWarmupSchedule overrides (its plateau state
    # must survive checkpoint/resume)
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict):
        pass


@dataclass
class StepSchedule(Scheduler):
    base_lr: float
    step_size: int
    gamma: float = 0.1

    def lr(self, epoch):
        return self.base_lr * self.gamma ** (epoch // self.step_size)


@dataclass
class MultiStepSchedule(Scheduler):
    base_lr: float
    milestones: Sequence[int]
    gamma: float = 0.1

    def lr(self, epoch):
        n = sum(1 for m in self.milestones if m <= epoch)
        return self.base_lr * self.gamma ** n


@dataclass
class MyStepSchedule(Scheduler):
    """StepLR clamped at min_lr."""
    base_lr: float
    step_size: int
    gamma: float = 0.1
    min_lr: float = 1e-6

    def lr(self, epoch):
        return max(self.base_lr * self.gamma ** (epoch // self.step_size),
                   self.min_lr)


@dataclass
class CosineSchedule(Scheduler):
    """CosineAnnealingLR closed form."""
    base_lr: float
    t_max: int
    eta_min: float = 0.0

    def lr(self, epoch):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * epoch / self.t_max)) / 2


@dataclass
class MyCosineSchedule(Scheduler):
    """lr = max(base * coef * (1 + cos((e-1) pi / max_epochs)), min_lr)."""
    base_lr: float
    coef: float
    max_epochs: int
    min_lr: float = 1e-9

    def lr(self, epoch):
        return max(
            self.base_lr * self.coef
            * (1.0 + math.cos((epoch - 1) * math.pi / self.max_epochs)),
            self.min_lr)


@dataclass
class MyWarmupSchedule(Scheduler):
    """Warmup to base lr over num_warmup_epoch, then plateau-decay by
    ``factor`` after ``patience`` bad epochs.  The ramp is at epoch
    granularity: ``lr(e) = base_lr * r / W`` for relative epoch r < W,
    reaching base_lr exactly when ``step`` pins it there."""
    base_lr: float
    min_lr: float = 1e-7
    mode: str = 'min'
    patience: int = 5
    factor: float = 0.1
    num_warmup_epoch: int = 5
    init_epoch: int = 0
    eps: float = 1e-11

    best: Optional[float] = None
    num_bad_epochs: int = 0
    current_lr: float = field(default=0.0)

    def __post_init__(self):
        if self.best is None:
            self.best = 1e10 if self.mode == 'min' else -1e10
        self.current_lr = self.base_lr

    def is_better(self, metric: float) -> bool:
        return metric < self.best if self.mode == 'min' \
            else metric > self.best

    def lr(self, epoch):
        relative_epoch = epoch - self.init_epoch + 1
        if relative_epoch < self.num_warmup_epoch:
            return self.base_lr * relative_epoch / self.num_warmup_epoch
        return self.current_lr

    def state_dict(self) -> dict:
        return {'best': self.best, 'num_bad_epochs': self.num_bad_epochs,
                'current_lr': self.current_lr}

    def load_state_dict(self, state: dict):
        self.best = state['best']
        self.num_bad_epochs = state['num_bad_epochs']
        self.current_lr = state['current_lr']

    def step(self, epoch, metric=None):
        relative_epoch = epoch - self.init_epoch + 1
        if relative_epoch == self.num_warmup_epoch:
            self.current_lr = self.base_lr

        if metric is not None:
            if self.is_better(float(metric)):
                self.best = float(metric)
                self.num_bad_epochs = 0
            elif relative_epoch > self.num_warmup_epoch:
                self.num_bad_epochs += 1

            if self.num_bad_epochs > self.patience:
                new_lr = self.current_lr * self.factor
                if self.current_lr - new_lr > self.eps:
                    self.current_lr = new_lr
                self.num_bad_epochs = 0
        return self.current_lr


def parse_milestones(raw) -> list:
    """Epoch milestones: '+'-separated strings as upstream documents
    them; ','-separated and int sequences stay accepted."""
    if raw is None:
        return []
    if isinstance(raw, str):
        return [int(m) for m in raw.replace('+', ',').split(',') if m]
    return [int(m) for m in raw]


def build_scheduler(hp, num_epochs: int, min_num_epochs: int
                    ) -> Optional[Scheduler]:
    if not hp.lr_scheduler:
        return None
    name = hp.name_lr_scheduler
    # every schedule but MYWARMUP runs off the base the optimizer was
    # built at (see effective_base_lr), not the configured opt__lr
    base = effective_base_lr(hp)
    if name == constants.STEP:
        return StepSchedule(base, hp.step_size, hp.gamma)
    if name == constants.MULTISTEP:
        return MultiStepSchedule(base, parse_milestones(hp.milestone),
                                 hp.gamma)
    if name == constants.MYSTEP:
        return MyStepSchedule(base, hp.step_size, hp.gamma, hp.min_lr)
    if name == constants.COSINE:
        return CosineSchedule(base, hp.t_max, hp.min_lr)
    if name == constants.MYCOSINE:
        return MyCosineSchedule(base, getattr(hp, 'coef', 0.5),
                                num_epochs, hp.min_lr)
    if name == constants.MYWARMUP:
        return MyWarmupSchedule(
            hp.lr, min_lr=hp.min_lr,
            mode='min' if hp.mode == constants.MIN_MODE else 'max',
            patience=hp.patience, factor=hp.factor,
            num_warmup_epoch=min_num_epochs)
    raise NotImplementedError(name)


def standardize_opt_params(config: dict):
    """'opt__lr' -> attribute 'lr' etc.  opt__-derived names win over
    plain keys that collide (the config carries both 'mode' =
    TRAINING/EVALUATION and 'opt__mode' = min/max)."""
    class HP:
        pass

    hp = HP()
    opt_names = {k.split('__', 1)[1] for k in config if
                 k.startswith('opt__')}
    for k, v in config.items():
        if k.startswith('opt__'):
            setattr(hp, k.split('__', 1)[1], v)
        elif k not in opt_names:
            setattr(hp, k, v)
    return hp
