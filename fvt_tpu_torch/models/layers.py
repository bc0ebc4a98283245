"""Shared building blocks of the port.

Counterparts of ``fvt_tpu/models/layers.py``: weight-norm materialisation
(``materialize_weight_norm``, ``layers.py:50-56``; differentiable, so the
train path takes gradients to v and g through it), eval BatchNorm folded
to a scale and shift (``serve.py:27-33``; the train-mode BatchNorm is
``F.batch_norm`` on the (B*T, C) view, in ``models/models.py``), and
seeded inits that follow
PyTorch's defaults but draw from an explicit ``torch.Generator``, and the
version stamp that keeps a module's derived weights
(:func:`stamp`).  PReLU
is ``nn.PReLU``, whose ``x if x >= 0 else alpha * x`` is ``layers.py``'s
``PReLU``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

BN_EPS = 1e-5


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g * v / max(||v||, 1e-12)`` per output channel, the norm taken
    over (Cin, K): v (Cout, Cin, K), g (Cout, 1, 1) in PyTorch's layout.
    Returns the conv kernel in the kernels' layout (K, Cin, Cout)."""
    norm = v.square().sum(dim=(1, 2), keepdim=True).sqrt()
    w = v * (g / norm.clamp_min(1e-12))
    return w.permute(2, 1, 0).contiguous()


def fold_batchnorm(bn: nn.modules.batchnorm._BatchNorm
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as ``x * scale + shift``, eps 1e-5 (``serve.py``'s
    ``_bn_eval``)."""
    inv = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return inv, bn.bias - bn.running_mean * inv


def stamp(*tensors: torch.Tensor) -> tuple:
    """Changes when one of ``tensors`` is replaced or written in place
    (an inference tensor keeps no version: only its replacement shows)."""
    return tuple((t.data_ptr(), 0 if t.is_inference() else t._version)
                 for t in tensors)


def uniform_(t: torch.Tensor, bound: float,
             generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def init_linear_(layer: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default Linear/Conv init, U(+-1/sqrt(fan_in)) for the
    weight and the bias, drawn from ``generator``."""
    fan_in = layer.weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in) if fan_in else 0.0
    uniform_(layer.weight, bound, generator)
    if getattr(layer, 'bias', None) is not None:
        uniform_(layer.bias, bound, generator)
