"""LFAN multimodal fusion, eval and train
(``fvt_tpu/models/fusion.py:22-90``).

Parameters keep the upstream PyTorch names that
``fvt_tpu.models.torch_export.lfan_to_torch`` writes under ``fusion.``:
``layers.self_attn.qkv_proj.<m>.{weight,bias}``,
``layers.self_attn.o_proj.{weight,bias}`` and ``layers.norm1.*``.  The
eval forward runs :func:`fvt_tpu_torch.ops.fusion.fused_multimodal_fusion`
on the weights the module keeps (:meth:`MultimodalTransformerEncoder.
eval_weights`); the train forward is plain differentiable PyTorch
(attention, dropout, LayerNorm), since the fused kernel has no backward
in ``fvt_tpu`` either.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fvt_tpu_torch.models.layers import stamp, uniform_
from fvt_tpu_torch.ops.fusion import (LN_EPS, fused_multimodal_fusion,
                                      fused_multimodal_fusion_ref,
                                      multimodal_attention_ref,
                                      pack_fusion_weights)


class MultimodalMultiheadAttention(nn.Module):
    def __init__(self, modalities: Sequence[str], input_dim: Dict[str, int],
                 modal_dim: int):
        super().__init__()
        self.qkv_proj = nn.ModuleDict(
            {m: nn.Linear(input_dim[m], 3 * modal_dim) for m in modalities})
        em = modal_dim * len(modalities)
        self.o_proj = nn.Linear(em, em)


class _EncoderLayer(nn.Module):
    def __init__(self, modalities, input_dim, modal_dim):
        super().__init__()
        self.self_attn = MultimodalMultiheadAttention(
            modalities, input_dim, modal_dim)
        self.norm1 = nn.LayerNorm(modal_dim * len(modalities), eps=1e-5)


class MultimodalTransformerEncoder(nn.Module):
    """One attention block over the modality slots, dropout, then
    LayerNorm.  In eval mode the dropout is the identity."""

    def __init__(self, modalities: Sequence[str], input_dim: Dict[str, int],
                 modal_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.modalities = tuple(modalities)
        self.modal_dim = modal_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.layers = _EncoderLayer(self.modalities, input_dim, modal_dim)
        self._eval = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform qkv and o_proj weights with zero biases
        (``fusion.py:46-68``); LayerNorm at ones and zeros."""
        attn = self.layers.self_attn
        for lin in [*attn.qkv_proj.values(), attn.o_proj]:
            fan_out, fan_in = lin.weight.shape
            uniform_(lin.weight, math.sqrt(6.0 / (fan_in + fan_out)),
                     generator)
            nn.init.zeros_(lin.bias)
        self.layers.norm1.reset_parameters()

    def eval_weights(self) -> dict:
        """The qkv and o_proj weights split and packed for the split-TF32
        kernel (``ops.fusion.pack_fusion_weights``), detached.  Derived
        once and kept; dropped and derived again when a parameter of the
        module is replaced or written in place (``load_state_dict``,
        ``.to()``, an optimizer step)."""
        version = stamp(*self.parameters())
        if self._eval is None or self._eval[0] != version:
            attn = self.layers.self_attn
            lins = [attn.qkv_proj[m] for m in self.modalities]
            with torch.no_grad():
                packed = pack_fusion_weights(
                    [lin.weight.t() for lin in lins],
                    [lin.bias for lin in lins], attn.o_proj.weight.t(),
                    modal_dim=self.modal_dim, num_heads=self.num_heads)
            self._eval = (version, packed)
        return self._eval[1]

    def forward(self, x: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None, *,
                reference: bool = False) -> torch.Tensor:
        attn = self.layers.self_attn
        lins = [attn.qkv_proj[m] for m in self.modalities]
        norm = self.layers.norm1
        xs = [x[m] for m in self.modalities]
        # the parameters as the functions take them (views, no copy)
        args = (xs, [lin.weight.t() for lin in lins],
                [lin.bias for lin in lins], attn.o_proj.weight.t(),
                attn.o_proj.bias)
        kw = dict(modal_dim=self.modal_dim, num_heads=self.num_heads)
        if train:
            o = multimodal_attention_ref(*args, **kw)
            # imported here: models.tcn imports nothing of this module
            from fvt_tpu_torch.models.tcn import dropout_mask
            o = o * dropout_mask(o.shape, self.dropout, True, o, generator)
            return F.layer_norm(o, (o.shape[-1],), norm.weight, norm.bias,
                                LN_EPS)
        if reference:
            return fused_multimodal_fusion_ref(*args, norm.weight,
                                               norm.bias, **kw)
        # the kernel reads the kept packed weights; the plain version on
        # the CPU reads the parameters
        packed = None if xs[0].device.type == 'cpu' else self.eval_weights()
        return fused_multimodal_fusion(*args, norm.weight, norm.bias, **kw,
                                       packed=packed)
