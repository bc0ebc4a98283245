"""The frozen VGGish of the ``logmel`` modality (``fvt_tpu/models/vggish.py``):
a (96, 64) log-mel patch -> a 128-d embedding.

The VGG conv stack ``[64, M, 128, M, 256, 256, M, 512, 512, M]`` (3x3
convolutions with padding 1, each followed by ReLU; 2x2 max-pools), then
the three Linear layers of the embeddings (12288 -> 4096, ReLU, 4096 ->
4096, ReLU, 4096 -> 128).  Parameter names are the upstream torch VGG's
(``features.{0,3,6,8,11,13}``, ``embeddings.{0,2,4}``), so an upstream
``spatial.audio.backbone.*`` state_dict loads as it is.

The convolutions run on ``F.conv2d`` (cuDNN on the card) in NCHW order,
in channels_last memory.  Before the flatten the activations are permuted
to (N, H, W, C): ``fvt_tpu`` flattens NHWC and the upstream model
transposes to (H, W, C) before its flatten, so ``embeddings.0.weight``
is the transpose of ``fvt_tpu``'s ``fc0`` kernel.  The ArcFace goes the
other way (its Linear is permuted instead), which an upstream VGGish
would load into and then compute something else.

``dtype=torch.bfloat16`` is ``fvt_tpu``'s ``--amp``: the input, the conv
kernels and biases in bfloat16, the conv's output rounded to bfloat16
before the bias is added in bfloat16 (flax's ``Conv(dtype=bf16)``), ReLU
and max-pool in bfloat16; the flatten and the three Linear layers in
float32, as there.  The parameters stay float32 (the convolutions
compute in ``dtype`` whatever the parameters' type).  The VGGish has no
BatchNorm and no dropout, so its train and eval forwards are one
function; the model runs it under ``torch.no_grad`` in training.
"""
from __future__ import annotations

from typing import Iterator, List

import torch
import torch.nn.functional as F
from torch import nn

from fvt_tpu_torch.models.arcface import cast_cached
from fvt_tpu_torch.models.layers import init_linear_

VGG_CFG = [64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M']
PATCH = (96, 64)
EMBEDDING_DIM = 128
# float32, bfloat16 (--amp), and float64, which the CPU tests run against
# fvt_tpu's VGGish(dtype=float64)
DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def feature_indices() -> List[int]:
    """Index in ``features`` of each conv layer, in order: a conv and its
    ReLU per width of :data:`VGG_CFG`, a max-pool per 'M'."""
    idx, out = 0, []
    for v in VGG_CFG:
        if v == 'M':
            idx += 1
        else:
            out.append(idx)
            idx += 2
    return out


def _layers() -> Iterator[nn.Module]:
    cin = 1
    for v in VGG_CFG:
        if v == 'M':
            yield nn.MaxPool2d(2, 2)
        else:
            yield nn.Conv2d(cin, v, 3, padding=1)
            yield nn.ReLU(inplace=True)
            cin = v


class VGGish(nn.Module):
    """x (N, 96, 64) log-mel patches, float32 -> (N, 128) float32."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError(f'dtype {dtype}: the VGGish computes in one of '
                             f'{DTYPES}')
        self.dtype = dtype
        self.features = nn.Sequential(*_layers())
        h, w = (n >> VGG_CFG.count('M') for n in PATCH)
        self.embeddings = nn.Sequential(
            nn.Linear(VGG_CFG[-2] * h * w, 4096), nn.ReLU(inplace=True),
            nn.Linear(4096, 4096), nn.ReLU(inplace=True),
            nn.Linear(4096, EMBEDDING_DIM))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default conv/Linear init, drawn from ``generator``."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                init_linear_(mod, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:  # (N, 96, 64, 1), fvt_tpu's NHWC
            x = x[..., 0]
        x = x.to(self.dtype)[:, None].contiguous(
            memory_format=torch.channels_last)
        for mod in self.features:
            if isinstance(mod, nn.Conv2d):
                w = cast_cached(mod, 'weight', self.dtype)
                b = cast_cached(mod, 'bias', self.dtype)
                if self.dtype != torch.bfloat16:
                    x = F.conv2d(x, w, b, padding=1)
                else:
                    x = F.conv2d(x, w, None, padding=1).add_(
                        b.view(1, -1, 1, 1))
                x = F.relu_(x)
            elif isinstance(mod, nn.MaxPool2d):
                x = F.max_pool2d(x, 2, 2)
        # the NHWC flatten (channels_last storage makes the permute free)
        # in float32, then in the Linear layers' type: float32, or float64
        # where the model was cast so, as flax's Dense promotes
        x = x.float().to(self.embeddings[0].weight.dtype).permute(0, 2, 3, 1)
        return self.embeddings(x.reshape(x.shape[0], -1))
