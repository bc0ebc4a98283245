"""Temporal Convolutional Network, eval mode (``fvt_tpu/models/tcn.py``).

Parameters keep the upstream PyTorch names that
``fvt_tpu.models.torch_export.tcn`` writes: per block
``conv1.weight_v (Cout, Cin, K)``, ``conv1.weight_g (Cout, 1, 1)``,
``conv1.bias``, the same for ``conv2``, and ``downsample.weight
(Cout, Cin, 1)``, ``downsample.bias`` where Cin != Cout
(``tcn.py:72-78``).  The forward runs each block through
:func:`fvt_tpu_torch.ops.tcn.fused_temporal_block`.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from fvt_tpu_torch.models.layers import init_linear_, uniform_, weight_norm
from fvt_tpu_torch.ops.tcn import tcn_forward


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


class TemporalBlock(nn.Module):
    """One block's weights; its dilation is ``2**i`` for block ``i`` of
    the stack (:func:`fvt_tpu_torch.ops.tcn.tcn_forward`)."""

    def __init__(self, n_inputs: int, n_outputs: int, kernel_size: int):
        super().__init__()
        self.conv1 = WeightNormConv1d(n_inputs, n_outputs, kernel_size)
        self.conv2 = WeightNormConv1d(n_outputs, n_outputs, kernel_size)
        self.downsample = (nn.Conv1d(n_inputs, n_outputs, 1)
                           if n_inputs != n_outputs else None)

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


class TemporalConvNet(nn.Module):
    """Stack of TemporalBlocks with dilation ``2**i``; input and output
    are feature-last ``(B, T, C)``."""

    def __init__(self, num_inputs: int, num_channels: Sequence[int],
                 kernel_size: int = 5):
        super().__init__()
        self.kernel_size = kernel_size
        blocks: List[TemporalBlock] = []
        cin = num_inputs
        for cout in num_channels:
            blocks.append(TemporalBlock(cin, cout, kernel_size))
            cin = cout
        self.network = nn.ModuleList(blocks)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for blk in self.network:
            blk.reset_parameters(generator)

    def forward(self, x: torch.Tensor, *,
                reference: bool = False) -> torch.Tensor:
        blocks = [blk.kernel_weights() for blk in self.network]
        return tcn_forward(x, blocks, self.kernel_size, reference=reference)
