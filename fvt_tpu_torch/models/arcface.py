"""ArcFace IR-ResNet-50, eval mode (``fvt_tpu/models/arcface.py:23-253``).

Input ``(N, 40, 40, 3)`` normalised face crops, output l2-normalised
512-d embeddings.  The modules and their names are those of the upstream
PyTorch ``Backbone`` that ``fvt_tpu.models.torch_export.arcface_to_torch``
writes: ``input_layer.{0,1,2}``, ``body.<i>.shortcut_layer.{0,1}``,
``body.<i>.res_layer.{0..4}``, ``output_layer.{0,3,4}``.  Activations are
NCHW tensors in channels_last memory, which is NHWC storage: the
hand-written kernels take them as NHWC views without a copy.  The flatten
before ``output_layer.3`` is NCHW as upstream (``fvt_tpu`` flattens NHWC
and the weight bridge permutes the Linear's columns to match).

The 3x3 convolutions of the body have a selectable path
(:data:`CONV_IMPLS`), the counterpart of ``fvt_tpu``'s
``VisualBackbone(conv_impl=...)``; ``fused_blocks`` routes the stride-1
blocks whose widths agree through the fused whole-block kernel, as
``arcface_forward_eval(fused_blocks=True)`` does there.  The defaults,
``'cudnn'`` and ``fused_blocks=False``, are PyTorch's own ``conv2d``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fvt_tpu_torch.models.layers import init_linear_
from fvt_tpu_torch.ops import bottleneck as bottleneck_ops
from fvt_tpu_torch.ops import conv as conv_ops
from fvt_tpu_torch.ops import winograd as winograd_ops

# 'cudnn': PyTorch's conv2d (default).  'winograd': the plain PyTorch
# Winograd F(2x2, 3x3), transform-domain tensors in device memory.
# 'winograd_kernel': the fused Winograd CUDA kernel.  'shifted_kernel': the
# nine-shifted-products CUDA kernel.
CONV_IMPLS = ('cudnn', 'winograd', 'winograd_kernel', 'shifted_kernel')


def get_blocks_50() -> List[Tuple[int, int, int]]:
    """(in_channel, depth, stride) per bottleneck (``arcface.py:89-97``)."""
    blocks = []
    for in_c, depth, num_units, stride in [(64, 64, 3, 1), (64, 128, 4, 2),
                                           (128, 256, 14, 2),
                                           (256, 512, 3, 2)]:
        blocks.append((in_c, depth, stride))
        blocks.extend([(depth, depth, 1)] * (num_units - 1))
    return blocks


def _stamp(*tensors: torch.Tensor) -> tuple:
    """Changes when one of ``tensors`` is replaced or written in place
    (an inference tensor keeps no version: only its replacement shows)."""
    return tuple((t.data_ptr(), 0 if t.is_inference() else t._version)
                 for t in tensors)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """The NHWC view of an NCHW tensor (no copy from channels_last)."""
    return x.permute(0, 2, 3, 1).contiguous()


class Conv3x3(nn.Module):
    """3x3 'same' convolution without bias, with a selectable path.

    The parameter is ``weight`` in OIHW, as ``nn.Conv2d``'s, so upstream
    checkpoints and the weight bridge load unchanged.  As in ``fvt_tpu``
    (``arcface.py:76``), only a stride-1 convolution takes a path other
    than ``'cudnn'``.  Those paths are eval-only and take the kernel in
    HWIO (and, for Winograd, its transform ``G g G^T``): both are derived
    from ``weight`` at the first call and kept; they are dropped and
    derived again when ``weight`` is replaced or written in place
    (``load_state_dict``, ``.to()``, an optimizer step, a re-init).
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 impl: str = 'cudnn'):
        super().__init__()
        if impl not in CONV_IMPLS:
            raise ValueError(f'unknown conv impl: {impl!r}')
        self.stride = stride
        self.impl = impl
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, 3, 3))
        self._derived = None

    def kernel_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(HWIO kernel (3, 3, Cin, Cout), its Winograd transform (16,
        Cin, Cout)), cached as the class docstring says."""
        stamp = _stamp(self.weight)
        if self._derived is None or self._derived[0] != stamp:
            with torch.no_grad():
                hwio = self.weight.permute(2, 3, 1, 0).contiguous()
                u = winograd_ops.transform_weights(hwio)
                u = u.reshape(16, *hwio.shape[2:])
            self._derived = (stamp, hwio, u)
        return self._derived[1:]

    def forward(self, x: torch.Tensor, reference: bool = False
                ) -> torch.Tensor:
        """x NCHW.  ``reference=True`` runs a kernel's plain version."""
        if self.stride != 1 or self.impl == 'cudnn':
            return F.conv2d(x, self.weight, None, self.stride, 1)
        conv_ops.refuse_grad(f'Conv3x3(impl={self.impl!r})', x, self.weight)
        hwio, u = self.kernel_weights()
        if self.impl == 'shifted_kernel':
            fn = conv_ops.conv3x3_ref if reference else conv_ops.conv3x3
            y = fn(_nhwc(x), hwio)
        else:
            plain = reference or self.impl == 'winograd'
            fn = (winograd_ops.conv3x3_winograd_ref if plain
                  else winograd_ops.conv3x3_winograd)
            y = fn(_nhwc(x), hwio, u)
        return y.permute(0, 3, 1, 2)


class BottleneckIR(nn.Module):
    """BN -> 3x3 conv -> PReLU -> 3x3 strided conv -> BN, + shortcut."""

    def __init__(self, in_channel: int, depth: int, stride: int,
                 conv_impl: str = 'cudnn'):
        super().__init__()
        self.stride = stride
        # the fused whole-block kernel takes the stride-1 identity blocks
        self.fusable = in_channel == depth and stride == 1
        if in_channel == depth:
            # upstream's MaxPool2d(1, stride): a strided view, no weights
            self.shortcut_layer = None
        else:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_channel, depth, 1, stride, bias=False),
                nn.BatchNorm2d(depth))
        self.res_layer = nn.Sequential(
            nn.BatchNorm2d(in_channel),
            Conv3x3(in_channel, depth, 1, conv_impl),
            nn.PReLU(depth),
            Conv3x3(depth, depth, stride, conv_impl),
            nn.BatchNorm2d(depth))
        self._fused = None

    def fused_weights(self) -> tuple:
        """(w1, w2, a1, b1, alpha, a2, b2) for the fused block: HWIO
        kernels and the folded eval BatchNorms.  Derived once and kept;
        dropped and derived again when any parameter or running statistic
        of the block is replaced or written in place."""
        bn1, conv1, prelu, conv2, bn2 = self.res_layer
        stamp = _stamp(conv1.weight, conv2.weight, prelu.weight,
                       *(t for bn in (bn1, bn2) for t in
                         (bn.weight, bn.bias, bn.running_mean,
                          bn.running_var)))
        if self._fused is None or self._fused[0] != stamp:
            with torch.no_grad():
                affine = [bottleneck_ops.bn_affine(
                    bn.weight, bn.bias, bn.running_mean, bn.running_var,
                    bn.eps) for bn in (bn1, bn2)]
                derived = (conv1.kernel_weights()[0],
                           conv2.kernel_weights()[0], *affine[0],
                           prelu.weight.detach(), *affine[1])
            self._fused = (stamp, derived)
        return self._fused[1]

    def forward(self, x: torch.Tensor, *, fused: bool = False,
                reference: bool = False) -> torch.Tensor:
        """x NCHW.  ``fused`` takes the whole-block kernel where the block
        is ``fusable``; ``reference=True`` runs the kernels' plain
        versions."""
        if fused and self.fusable:
            fn = (bottleneck_ops.bottleneck_ir_fused_ref if reference
                  else bottleneck_ops.bottleneck_ir_fused)
            conv_ops.refuse_grad('BottleneckIR(fused)', x,
                                 *self.res_layer.parameters())
            return fn(_nhwc(x), *self.fused_weights()).permute(0, 3, 1, 2)
        if self.shortcut_layer is None:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = self.shortcut_layer(x)
        bn1, conv1, prelu, conv2, bn2 = self.res_layer
        res = prelu(conv1(bn1(x), reference))
        return bn2(conv2(res, reference)) + shortcut


class Backbone(nn.Module):
    def __init__(self, drop_ratio: float = 0.4, conv_impl: str = 'cudnn'):
        super().__init__()
        # Cin = 3 makes a poor product: the input conv stays on conv2d
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=False), nn.BatchNorm2d(64),
            nn.PReLU(64))
        self.body = nn.ModuleList(
            BottleneckIR(*blk, conv_impl=conv_impl)
            for blk in get_blocks_50())
        self.output_layer = nn.Sequential(
            nn.BatchNorm2d(512), nn.Dropout(drop_ratio), nn.Flatten(),
            nn.Linear(512 * 5 * 5, 512), nn.BatchNorm1d(512))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyTorch's default conv/Linear init from ``generator``; BN at
        identity and PReLU at 0.25, as their own defaults."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear, Conv3x3)):
                init_linear_(mod, generator)

    def forward(self, x: torch.Tensor, *, fused_blocks: bool = False,
                reference: bool = False) -> torch.Tensor:
        """x (N, 40, 40, 3) -> (N, 512)."""
        x = x.permute(0, 3, 1, 2)  # NHWC storage == NCHW channels_last
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.input_layer(x)
        for blk in self.body:
            x = blk(x, fused=fused_blocks, reference=reference)
        x = self.output_layer(x)
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


class VisualBackbone(nn.Module):
    """Wrapper holding ``backbone`` (upstream ``backbone.py:69-130``).
    ``conv_impl`` (one of :data:`CONV_IMPLS`) and ``fused_blocks`` pick
    the path of the body's 3x3 convolutions in eval mode."""

    def __init__(self, conv_impl: str = 'cudnn', fused_blocks: bool = False):
        super().__init__()
        self.fused_blocks = fused_blocks
        self.backbone = Backbone(conv_impl=conv_impl)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)

    def forward(self, x: torch.Tensor, reference: bool = False
                ) -> torch.Tensor:
        return self.backbone(x, fused_blocks=self.fused_blocks,
                             reference=reference)


def arcface_forward_eval(model: VisualBackbone, x: torch.Tensor,
                         fused_blocks: bool = False,
                         reference: bool = False) -> torch.Tensor:
    """Eval forward of ``model`` on x (N, 40, 40, 3) with the fused
    whole-block kernel switched by the call and not by the module, the
    counterpart of ``fvt_tpu``'s ``arcface_forward_eval(...,
    fused_blocks=...)``.  The same math as ``model(x)``."""
    with torch.inference_mode():
        return model.backbone(x, fused_blocks=fused_blocks,
                              reference=reference)
