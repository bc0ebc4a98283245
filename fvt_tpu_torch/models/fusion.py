"""The fusion blocks of the four families (``fvt_tpu/models/fusion.py``):
LFAN's multimodal attention (``:22-90``), CAN's gating
(:class:`AttentionFusion`, ``:93-106``) and JMT's and MT's transformer
fusion (:class:`JointFusion`, ``:109-210``).

LFAN's multimodal attention, eval and train:

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

from fvt_tpu_torch.models.layers import (MultiheadAttention, init_linear_,
                                         stamp, uniform_)
from fvt_tpu_torch.ops.fusion import (LN_EPS, fused_multimodal_fusion,
                                      fused_multimodal_fusion_ref,
                                      multimodal_attention_ref,
                                      pack_fusion_weights)
from fvt_tpu_torch.parallel import collectives


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


class AttentionFusion(nn.Module):
    """CAN's gating: each modality projected to ``num_out_feats``, the
    projections concatenated, a softmax over the concatenation's features
    from one more Linear, the product.  ``attn.<i>`` and ``weights`` are
    the upstream names."""

    def __init__(self, input_dims: Sequence[int], num_out_feats: int = 128):
        super().__init__()
        self.attn = nn.ModuleList(nn.Linear(d, num_out_feats)
                                  for d in input_dims)
        n = num_out_feats * len(self.attn)
        self.weights = nn.Linear(n, n)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (*self.attn, self.weights):
            init_linear_(lin, generator)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        cat = torch.cat([lin(x) for lin, x in zip(self.attn, xs)], dim=-1)
        return torch.softmax(self.weights(cat), dim=-1) * cat


class TransformerEncoderLayer(nn.Module):
    """Post-norm: ``LN(x + attention(x))``, then ``LN(x + ff(x))`` with a
    ReLU feed-forward; no dropout (``fusion.py:109-124``)."""

    def __init__(self, dim: int, num_heads: int, hidden_dim: int):
        super().__init__()
        self.attention = MultiheadAttention(dim, num_heads)
        self.feed_forward = nn.Sequential(nn.Linear(dim, hidden_dim),
                                          nn.ReLU(),
                                          nn.Linear(hidden_dim, dim))
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attention.reset_parameters(generator)
        init_linear_(self.feed_forward[0], generator)
        init_linear_(self.feed_forward[2], generator)
        self.layer_norm1.reset_parameters()
        self.layer_norm2.reset_parameters()

    def forward(self, x: torch.Tensor,
                key_valid_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.layer_norm1(x + self.attention(x, x, x, key_valid_mask))
        return self.layer_norm2(x + self.feed_forward(x))


class TransformerEncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, hidden_dim: int,
                 num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(dim, num_heads, hidden_dim)
            for _ in range(num_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor,
                key_valid_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, key_valid_mask)
        return x


class JointFusion(nn.Module):
    """JMT's fusion (``joint=True``) or MT's (``joint=False``),
    ``fusion.py:140-210``: the audio stream widened to 128; visual, audio
    and (JMT) joint encoders; 2 or 6 cross-attentions; the final encoder
    and self-attention over the cross-attentions stacked as the batch and
    the flattened (B*T) timeline as the sequence, the last slot taken.
    Rows mix when B > 1 and no mask is given, as in ``fvt_tpu`` (which
    trains so at B = 16); its eval runs one video a forward.

    ``time_mask`` (B, T) marks the valid frames: every attention's keys,
    the final ones over the flattened mask."""

    DIM = 128
    CROSS = (('CA_va', 'v', 'a'), ('CA_av', 'a', 'v'))
    JOINT_CROSS = (('CA_jrv', 'jr', 'v'), ('CA_vjr', 'v', 'jr'),
                   ('CA_jra', 'jr', 'a'), ('CA_ajr', 'a', 'jr'))

    def __init__(self, audio_dim: int, joint: bool = True):
        super().__init__()
        d = self.DIM
        self.joint = joint

        def block():
            return TransformerEncoderBlock(d, 1, d, 1)

        self.augment_audio_feats_dim = nn.Linear(audio_dim, d)
        self.visual_encoder = block()
        self.audio_encoder = block()
        self.cross = self.CROSS + (self.JOINT_CROSS if joint else ())
        if joint:
            self.reduce_feats_dim = nn.Linear(2 * d, d)
            self.jr_encoder = block()
        for name, _, _ in self.cross:
            setattr(self, name, MultiheadAttention(d, 1))
        self.final_encoder = block()
        self.final_self_attention = MultiheadAttention(d, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_linear_(self.augment_audio_feats_dim, generator)
        self.visual_encoder.reset_parameters(generator)
        self.audio_encoder.reset_parameters(generator)
        if self.joint:
            init_linear_(self.reduce_feats_dim, generator)
            self.jr_encoder.reset_parameters(generator)
        for name, _, _ in self.cross:
            getattr(self, name).reset_parameters(generator)
        self.final_encoder.reset_parameters(generator)
        self.final_self_attention.reset_parameters(generator)

    def forward(self, visual: torch.Tensor, audio: torch.Tensor,
                time_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """visual (B, T, 128), audio (B, T, audio_dim) -> (B, T, 128)."""
        b, t, d = visual.shape
        if d != self.DIM:
            raise ValueError(f'the visual stream is {d}-d, not {self.DIM}')
        audio = self.augment_audio_feats_dim(audio)
        enc = {'v': self.visual_encoder(visual, time_mask),
               'a': self.audio_encoder(audio, time_mask)}
        if self.joint:
            jr = self.reduce_feats_dim(torch.cat([visual, audio], dim=-1))
            enc['jr'] = self.jr_encoder(jr, time_mask)
        stack = [getattr(self, name)(enc[q], enc[kv], enc[kv], time_mask)
                 for name, q, kv in self.cross]
        n = len(stack)
        # in a sharded data-parallel step or serving call the final
        # attention spans the global batch's timeline: every rank's rows
        # gathered, its own kept, and their masks gathered in the same order
        s = collectives.gather_rows(torch.stack(stack).reshape(n, b * t, d),
                                    1)
        if time_mask is not None and collectives.current() is not None:
            time_mask = collectives.gather_rows(
                time_mask.to(torch.uint8), 0).to(time_mask.dtype)
        flat_mask = (None if time_mask is None
                     else time_mask.reshape(1, -1).expand(n, -1))
        s = self.final_encoder(s, flat_mask)
        s = self.final_self_attention(s, s, s, flat_mask)
        return collectives.own_rows(s.reshape(n, -1, t, d)[-1])
