"""ArcFace IR-ResNet-50, eval mode (``fvt_tpu/models/arcface.py:89-165``).

Input ``(N, 40, 40, 3)`` normalised face crops, output l2-normalised
512-d embeddings.  The modules and their names are those of the upstream
PyTorch ``Backbone`` that ``fvt_tpu.models.torch_export.arcface_to_torch``
writes: ``input_layer.{0,1,2}``, ``body.<i>.shortcut_layer.{0,1}``,
``body.<i>.res_layer.{0..4}``, ``output_layer.{0,3,4}``.  The convolutions
run as PyTorch's own ``conv2d`` in channels_last; the flatten before
``output_layer.3`` is NCHW as upstream (``fvt_tpu`` flattens NHWC and the
weight bridge permutes the Linear's columns to match).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from fvt_tpu_torch.models.layers import init_linear_


def get_blocks_50() -> List[Tuple[int, int, int]]:
    """(in_channel, depth, stride) per bottleneck (``arcface.py:89-97``)."""
    blocks = []
    for in_c, depth, num_units, stride in [(64, 64, 3, 1), (64, 128, 4, 2),
                                           (128, 256, 14, 2),
                                           (256, 512, 3, 2)]:
        blocks.append((in_c, depth, stride))
        blocks.extend([(depth, depth, 1)] * (num_units - 1))
    return blocks


class BottleneckIR(nn.Module):
    """BN -> 3x3 conv -> PReLU -> 3x3 strided conv -> BN, + shortcut."""

    def __init__(self, in_channel: int, depth: int, stride: int):
        super().__init__()
        self.stride = stride
        if in_channel == depth:
            # upstream's MaxPool2d(1, stride): a strided view, no weights
            self.shortcut_layer = None
        else:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_channel, depth, 1, stride, bias=False),
                nn.BatchNorm2d(depth))
        self.res_layer = nn.Sequential(
            nn.BatchNorm2d(in_channel),
            nn.Conv2d(in_channel, depth, 3, 1, 1, bias=False),
            nn.PReLU(depth),
            nn.Conv2d(depth, depth, 3, stride, 1, bias=False),
            nn.BatchNorm2d(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shortcut_layer is None:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = self.shortcut_layer(x)
        return self.res_layer(x) + shortcut


class Backbone(nn.Module):
    def __init__(self, drop_ratio: float = 0.4):
        super().__init__()
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=False), nn.BatchNorm2d(64),
            nn.PReLU(64))
        self.body = nn.ModuleList(
            BottleneckIR(*blk) for blk in get_blocks_50())
        self.output_layer = nn.Sequential(
            nn.BatchNorm2d(512), nn.Dropout(drop_ratio), nn.Flatten(),
            nn.Linear(512 * 5 * 5, 512), nn.BatchNorm1d(512))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default conv/Linear init from ``generator``; BN at
        identity and PReLU at 0.25, as their own defaults."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                init_linear_(mod, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 40, 40, 3) -> (N, 512)."""
        x = x.permute(0, 3, 1, 2)  # NHWC storage == NCHW channels_last
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.input_layer(x)
        for blk in self.body:
            x = blk(x)
        x = self.output_layer(x)
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


class VisualBackbone(nn.Module):
    """Wrapper holding ``backbone`` (upstream ``backbone.py:69-130``)."""

    def __init__(self):
        super().__init__()
        self.backbone = Backbone()

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)
