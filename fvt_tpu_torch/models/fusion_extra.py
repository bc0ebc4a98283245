"""The remaining fusion variants of the reference model zoo
(``fvt_tpu/models/fusion_extra.py``): the gated multi-head attention
(``:23-54``), the intra-modal transformer encoder and its post-norm block
(``:57-92``), the inter-modal transformer encoder (``:95-118``) and the
TCN's attention block (``:121-142``).

Only :class:`TCNAttentionBlock` is on a path: ``TemporalConvNet(
attention=1)`` runs one after every temporal block
(``models/tcn.py``).  The others are part of the reference's API, as in
``fvt_tpu``, where no model builds them.  All five are plain PyTorch, as
their ``fvt_tpu`` counterparts are plain flax: none reaches a Pallas
kernel.

Module names follow the flax ones (``qkv_proj``, ``o_proj``,
``self_attn``, ``norm1``, ``ff1``, ``ff2``, ``norm2``, ``key_layer``,
``query_layer``, ``value_layer``; the intra-modal stack's ``layer<i>`` is
``layers.<i>``), so ``from_jax.module_state_from_flax`` and
``to_jax.module_flax_from_state`` carry their weights both ways.  Dropout
is drawn from an explicit generator in train mode, as elsewhere in the
port; eval mode is the forward's ``train=False``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fvt_tpu_torch.models.fusion import MultimodalMultiheadAttention
from fvt_tpu_torch.models.layers import init_linear_, uniform_
from fvt_tpu_torch.ops.fusion import multimodal_attention_ref


def _xavier_zero_(lin: nn.Linear, generator: torch.Generator) -> None:
    """Xavier-uniform weight, zero bias (the reference's qkv and o_proj,
    ``transformer.py:67-71``)."""
    fan_out, fan_in = lin.weight.shape
    uniform_(lin.weight, math.sqrt(6.0 / (fan_in + fan_out)), generator)
    nn.init.zeros_(lin.bias)


def _dropout(x: torch.Tensor, p: float, train: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    if not train or p == 0.0:
        return x
    # imported here: models.tcn imports this module
    from fvt_tpu_torch.models.tcn import dropout_mask
    return x * dropout_mask(x.shape, p, True, x, generator)


class GatedMultiheadAttention(nn.Module):
    """Packed qkv, optionally gated: the projection ``(B, T, 3E)`` is
    viewed ``(B, T, H, 3 hd)`` and split, so q, k and v interleave per
    head; ``gate`` (B, hd) multiplies q and k over the sequence."""

    def __init__(self, input_dim: int, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f'{num_heads} heads do not divide {embed_dim}')
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.qkv_proj = nn.Linear(input_dim, 3 * embed_dim)
        self.o_proj = nn.Linear(embed_dim, embed_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _xavier_zero_(self.qkv_proj, generator)
        _xavier_zero_(self.o_proj, generator)

    def forward(self, x: torch.Tensor,
                gate: Optional[torch.Tensor] = None) -> torch.Tensor:
        e, h = self.embed_dim, self.num_heads
        hd = e // h
        b, t, _ = x.shape
        qkv = self.qkv_proj(x).reshape(b, t, h, 3 * hd).transpose(1, 2)
        q, k, v = qkv.split(hd, dim=-1)
        if gate is not None:
            g = gate[:, None, None, :]
            q, k = q * g, k * g
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        values = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.o_proj(values.transpose(1, 2).reshape(b, t, e))


class IntraEncoderBlock(nn.Module):
    """Post-norm: ``LN(x + drop(attn(x)))``, then ``LN(x + drop(ff(x)))``
    with the feed-forward's dropout before its ReLU."""

    def __init__(self, input_dim: int, num_heads: int, dim_feedforward: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = GatedMultiheadAttention(input_dim, input_dim,
                                                 num_heads)
        self.norm1 = nn.LayerNorm(input_dim, eps=1e-5)
        self.ff1 = nn.Linear(input_dim, dim_feedforward)
        self.ff2 = nn.Linear(dim_feedforward, input_dim)
        self.norm2 = nn.LayerNorm(input_dim, eps=1e-5)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.self_attn.reset_parameters(generator)
        init_linear_(self.ff1, generator)
        init_linear_(self.ff2, generator)
        self.norm1.reset_parameters()
        self.norm2.reset_parameters()

    def forward(self, x: torch.Tensor, gate: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        p = self.dropout
        x = self.norm1(x + _dropout(self.self_attn(x, gate), p, train,
                                    generator))
        ff = F.relu(_dropout(self.ff1(x), p, train, generator))
        return self.norm2(x + _dropout(self.ff2(ff), p, train, generator))


class IntraModalTransformerEncoder(nn.Module):
    """A stack of :class:`IntraEncoderBlock` sharing one gate."""

    def __init__(self, num_layers: int, input_dim: int, num_heads: int,
                 dim_feedforward: int, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            IntraEncoderBlock(input_dim, num_heads, dim_feedforward, dropout)
            for _ in range(num_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor, gate: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, gate, train, generator)
        return x


class InterModalTransformerEncoder(nn.Module):
    """Per-frame attention over the modality slots (LFAN's, the port's
    :class:`MultimodalMultiheadAttention` and its plain math), dropout,
    LayerNorm, then a ReLU MLP and a second LayerNorm, without a
    residual."""

    def __init__(self, modalities: Sequence[str], input_dim: Dict[str, int],
                 modal_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.modalities = tuple(modalities)
        self.modal_dim = modal_dim
        self.num_heads = num_heads
        self.dropout = dropout
        out_dim = modal_dim * len(self.modalities)
        self.self_attn = MultimodalMultiheadAttention(
            self.modalities, input_dim, modal_dim)
        self.norm1 = nn.LayerNorm(out_dim, eps=1e-5)
        self.ff1 = nn.Linear(out_dim, out_dim)
        self.ff2 = nn.Linear(out_dim, out_dim)
        self.norm2 = nn.LayerNorm(out_dim, eps=1e-5)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modalities:
            _xavier_zero_(self.self_attn.qkv_proj[m], generator)
        _xavier_zero_(self.self_attn.o_proj, generator)
        init_linear_(self.ff1, generator)
        init_linear_(self.ff2, generator)
        self.norm1.reset_parameters()
        self.norm2.reset_parameters()

    def forward(self, x: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        attn = self.self_attn
        lins = [attn.qkv_proj[m] for m in self.modalities]
        o = multimodal_attention_ref(
            [x[m] for m in self.modalities], [lin.weight.t() for lin in lins],
            [lin.bias for lin in lins], attn.o_proj.weight.t(),
            attn.o_proj.bias, modal_dim=self.modal_dim,
            num_heads=self.num_heads)
        h = self.norm1(_dropout(o, self.dropout, train, generator))
        ff = F.relu(_dropout(self.ff1(h), self.dropout, train, generator))
        return self.norm2(self.ff2(ff))


class TCNAttentionBlock(nn.Module):
    """The reference TCN's attention block on (B, N, D): keys, queries and
    values by Linear layers from D; ``softmax`` of ``q k^T`` over the
    QUERY axis (dim 1 of (B, Nq, Nk)) under the causal ``triu(k=1)`` mask,
    divided by ``sqrt(k_size)`` after the softmax, NaN set to 0; the
    values read by it added to the input (``v_size == D``)."""

    def __init__(self, in_dim: int, k_size: int, v_size: int):
        super().__init__()
        self.k_size = k_size
        self.key_layer = nn.Linear(in_dim, k_size)
        self.query_layer = nn.Linear(in_dim, k_size)
        self.value_layer = nn.Linear(in_dim, v_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.key_layer, self.query_layer, self.value_layer):
            init_linear_(lin, generator)

    def forward(self, minibatch: torch.Tensor) -> torch.Tensor:
        n = minibatch.shape[1]
        keys = self.key_layer(minibatch)
        queries = self.query_layer(minibatch)
        values = self.value_layer(minibatch)
        logits = torch.matmul(queries, keys.transpose(1, 2))
        mask = torch.ones(n, n, dtype=torch.bool,
                          device=minibatch.device).triu(1)
        logits = logits.masked_fill(mask, float('-inf'))
        probs = torch.softmax(logits, dim=1) / math.sqrt(self.k_size)
        probs = torch.where(torch.isnan(probs), 0.0, probs)
        return minibatch + torch.matmul(probs, values)
