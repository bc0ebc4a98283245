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
``PReLU``.  :func:`multihead_attention` and :class:`MultiheadAttention`
are ``TorchMultiheadAttention`` (``layers.py:286-338``), the attention
over time of JMT and MT.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
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


def multihead_attention(query: torch.Tensor, key: torch.Tensor,
                        value: torch.Tensor, in_proj_weight: torch.Tensor,
                        in_proj_bias: torch.Tensor, out_weight: torch.Tensor,
                        out_bias: torch.Tensor, num_heads: int,
                        key_valid_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``fvt_tpu``'s ``TorchMultiheadAttention`` on batch-first (B, L, E)
    tensors: the packed in_proj (3E, E) split into q, k and v, heads as
    (B, H, L, E/H), ``softmax(q k^T / sqrt(E/H)) v``, out_proj.
    ``key_valid_mask`` (B, L_k) marks the valid keys; the logits of the
    others become float32's most negative value, not -inf, as there, so a
    row without a valid key attends uniformly."""
    e = query.shape[-1]
    hd = e // num_heads

    def heads(x, i):  # (B, L, E) -> (B, H, L, hd)
        x = F.linear(x, in_proj_weight[i * e:(i + 1) * e],
                     in_proj_bias[i * e:(i + 1) * e])
        return x.reshape(x.shape[0], x.shape[1], num_heads,
                         hd).transpose(1, 2)

    q, k, v = heads(query, 0), heads(key, 1), heads(value, 2)
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if key_valid_mask is not None:
        logits = torch.where(key_valid_mask[:, None, None, :], logits,
                             torch.finfo(logits.dtype).min)
    out = torch.matmul(torch.softmax(logits, dim=-1), v)
    b, _, l, _ = out.shape
    out = out.transpose(1, 2).reshape(b, l, e)
    return F.linear(out, out_weight, out_bias)


class MultiheadAttention(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` under its names
    (``in_proj_weight``, ``in_proj_bias``, ``out_proj.*``), so upstream
    weights load as they are; the forward is :func:`multihead_attention`,
    whose masking is ``fvt_tpu``'s."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f'{num_heads} heads do not divide {embed_dim}')
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform in_proj, Linear's default out_proj weight, zero
        biases (``nn.MultiheadAttention._reset_parameters``)."""
        fan_out, fan_in = self.in_proj_weight.shape
        uniform_(self.in_proj_weight, math.sqrt(6.0 / (fan_in + fan_out)),
                 generator)
        nn.init.zeros_(self.in_proj_bias)
        init_linear_(self.out_proj, generator)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_valid_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return multihead_attention(
            query, key, value, self.in_proj_weight, self.in_proj_bias,
            self.out_proj.weight, self.out_proj.bias, self.num_heads,
            key_valid_mask)
