"""Temporal Convolutional Network, eval and train
(``fvt_tpu/models/tcn.py``).

Parameters keep the upstream PyTorch names that
``fvt_tpu.models.torch_export.tcn`` writes: per block
``conv1.weight_v (Cout, Cin, K)``, ``conv1.weight_g (Cout, 1, 1)``,
``conv1.bias``, the same for ``conv2``, and ``downsample.weight
(Cout, Cin, 1)``, ``downsample.bias`` where Cin != Cout
(``tcn.py:72-78``).  The eval forward runs each block through
:func:`fvt_tpu_torch.ops.tcn.fused_temporal_block` on the weights the
block keeps (:meth:`TemporalBlock.eval_weights`); the train forward
runs it through :func:`fvt_tpu_torch.ops.tcn.fused_temporal_block_train`
with the 1x1 downsample and the dropout masks made outside the kernel
(``tcn.py:34-63``), or layer by layer on ``F.conv1d`` with the same
masks (``fused=False``, ``tcn.py:65-81``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fvt_tpu_torch.models.fusion_extra import TCNAttentionBlock
from fvt_tpu_torch.models.layers import (init_linear_, stamp, uniform_,
                                         weight_norm)
from fvt_tpu_torch.ops.tcn import (NEG_SLOPE, _causal_conv,
                                   fused_temporal_block_train,
                                   fused_temporal_block_train_ref,
                                   pack_block_weights, tcn_forward)
from fvt_tpu_torch.parallel import collectives


class WeightNormConv1d(nn.Module):
    """Holds a weight-normalised conv1d: ``weight_v``, ``weight_g``,
    ``bias``."""

    def __init__(self, n_inputs: int, n_outputs: int, kernel_size: int):
        super().__init__()
        self.weight_v = nn.Parameter(
            torch.empty(n_outputs, n_inputs, kernel_size))
        self.weight_g = nn.Parameter(torch.empty(n_outputs, 1, 1))
        self.bias = nn.Parameter(torch.empty(n_outputs))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight_v[0].numel())
        uniform_(self.weight_v, bound, generator)
        uniform_(self.bias, bound, generator)
        with torch.no_grad():  # g = ||v|| at init, as weight_norm sets it
            self.weight_g.copy_(self.weight_v.square().sum(
                dim=(1, 2), keepdim=True).sqrt())


def dropout_mask(shape, p: float, train: bool, like: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """A dropout mask pre-scaled to {0, 1/(1-p)}, drawn from
    ``generator`` (on ``like``'s device); ones at eval or ``p == 0``."""
    if not train or p == 0.0:
        return torch.ones(shape, device=like.device, dtype=like.dtype)
    if generator is None:
        raise ValueError('dropout in train mode draws from an explicit '
                         'torch.Generator')
    # in a sharded data-parallel step: the global batch's mask, this
    # rank's rows of it
    n, lo, hi = collectives.rows(shape[0])
    keep = torch.full((n,) + tuple(shape[1:]), 1.0 - p, device=like.device,
                      dtype=like.dtype)
    mask = torch.bernoulli(keep, generator=generator) / (1.0 - p)
    return mask if n == shape[0] else mask[lo:hi]


class TemporalBlock(nn.Module):
    """One block's weights; its dilation is ``2**i`` for block ``i`` of
    the stack (:func:`fvt_tpu_torch.ops.tcn.tcn_forward`)."""

    def __init__(self, n_inputs: int, n_outputs: int, kernel_size: int,
                 dilation: int = 1, dropout: float = 0.0):
        super().__init__()
        self.n_outputs = n_outputs
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.dropout = dropout
        self.conv1 = WeightNormConv1d(n_inputs, n_outputs, kernel_size)
        self.conv2 = WeightNormConv1d(n_outputs, n_outputs, kernel_size)
        self.downsample = (nn.Conv1d(n_inputs, n_outputs, 1)
                           if n_inputs != n_outputs else None)
        self._eval = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.conv1.reset_parameters(generator)
        self.conv2.reset_parameters(generator)
        if self.downsample is not None:
            init_linear_(self.downsample, generator)

    def kernel_weights(self) -> dict:
        """The block's weights in the kernel's layout:
        w1 (K, Cin, Cout), w2 (K, Cout, Cout), wd (Cin, Cout) or None."""
        ds = self.downsample
        return {
            'w1': weight_norm(self.conv1.weight_v, self.conv1.weight_g),
            'b1': self.conv1.bias,
            'w2': weight_norm(self.conv2.weight_v, self.conv2.weight_g),
            'b2': self.conv2.bias,
            'wd': None if ds is None else ds.weight[:, :, 0].t().contiguous(),
            'bd': None if ds is None else ds.bias,
        }

    def eval_weights(self) -> dict:
        """:meth:`kernel_weights` detached, and under ``packed`` the
        weights split and packed for the split-TF32 eval kernel
        (``ops.tcn.pack_block_weights``): what the eval forward computes
        with.  Derived once and kept; dropped and derived again when a
        parameter of the block is replaced or written in place
        (``load_state_dict``, ``.to()``, an optimizer step)."""
        version = stamp(*self.parameters())
        if self._eval is None or self._eval[0] != version:
            with torch.no_grad():
                w = self.kernel_weights()
                w['packed'] = pack_block_weights(w['w1'], w['w2'], w['wd'],
                                                 dilation=self.dilation)
            self._eval = (version, w)
        return self._eval[1]

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                *, fused: bool = True, reference: bool = False
                ) -> torch.Tensor:
        """The differentiable block on x (B, T, Cin).  ``masks`` (m1, m2),
        each (B, T, Cout) and pre-scaled, take the place of the draw from
        ``generator``.  ``fused`` runs the fused train kernel
        (``reference=True``: its plain version), else conv by conv."""
        w = self.kernel_weights()
        res = x if w['wd'] is None else x @ w['wd'] + w['bd']
        shape = x.shape[:2] + (self.n_outputs,)
        m1, m2 = masks if masks is not None else (
            dropout_mask(shape, self.dropout, train, x, generator),
            dropout_mask(shape, self.dropout, train, x, generator))
        if fused:
            fn = (fused_temporal_block_train_ref if reference
                  else fused_temporal_block_train)
            return fn(x, w['w1'], w['b1'], w['w2'], w['b2'], m1, m2, res,
                      kernel_size=self.kernel_size, dilation=self.dilation)
        net = F.leaky_relu(_causal_conv(x, w['w1'], w['b1'], self.dilation),
                           NEG_SLOPE) * m1
        net = F.leaky_relu(_causal_conv(net, w['w2'], w['b2'],
                                        self.dilation), NEG_SLOPE) * m2
        return F.leaky_relu(net + res, NEG_SLOPE)


class TemporalConvNet(nn.Module):
    """Stack of TemporalBlocks with dilation ``2**i``; input and output
    are feature-last ``(B, T, C)``.

    ``attention=1`` runs a :class:`~fvt_tpu_torch.models.fusion_extra.
    TCNAttentionBlock` ``attn[i]`` after block ``i`` (``fvt_tpu/models/
    tcn.py:99-108``), on the transposed ``(B, C, T)`` layout: attention
    over the channels with time as the features, so T must equal
    ``max_length``.  The upstream ``model.pt`` has no names for these
    blocks; ``fvt_tpu``'s tree keeps them at ``temporal_<m>/attn<i>``."""

    def __init__(self, num_inputs: int, num_channels: Sequence[int],
                 kernel_size: int = 5, dropout: float = 0.0,
                 attention: int = 0, max_length: int = 200):
        super().__init__()
        self.kernel_size = kernel_size
        self.attention = attention
        self.max_length = max_length
        blocks: List[TemporalBlock] = []
        cin = num_inputs
        for i, cout in enumerate(num_channels):
            blocks.append(TemporalBlock(cin, cout, kernel_size,
                                        dilation=2 ** i, dropout=dropout))
            cin = cout
        self.network = nn.ModuleList(blocks)
        if attention == 1:
            self.attn = nn.ModuleList(
                TCNAttentionBlock(max_length, max_length, max_length)
                for _ in num_channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i, blk in enumerate(self.network):
            blk.reset_parameters(generator)
            if self.attention == 1:
                self.attn[i].reset_parameters(generator)

    def _attend(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self.attention != 1:
            return x
        return self.attn[i](x.transpose(1, 2)).transpose(1, 2)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, *,
                fused: bool = True, reference: bool = False) -> torch.Tensor:
        """Eval (``train=False``): the fused eval kernel block by block,
        no gradient (with ``attention=1``, ``attn[i]`` between the
        blocks).  Train: the differentiable blocks, with dropout masks
        drawn from ``generator`` in block order."""
        if not train:
            blocks = [blk.kernel_weights() if reference
                      else blk.eval_weights() for blk in self.network]
            return tcn_forward(x, blocks, self.kernel_size,
                               reference=reference, after=self._attend)
        for i, blk in enumerate(self.network):
            x = self._attend(i, blk(x, True, generator, fused=fused,
                                    reference=reference))
        return x
