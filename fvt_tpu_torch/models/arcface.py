"""ArcFace IR-ResNet-50, eval and train mode
(``fvt_tpu/models/arcface.py:23-253``).

Input ``(N, 40, 40, 3)`` normalised face crops, output l2-normalised
512-d embeddings.  The modules and their names are those of the upstream
PyTorch ``Backbone`` that ``fvt_tpu.models.torch_export.arcface_to_torch``
writes: ``input_layer.{0,1,2}``, ``body.<i>.shortcut_layer.{0,1}``,
``body.<i>.res_layer.{0..4}``, ``output_layer.{0,3,4}``.  Activations are
NCHW tensors in channels_last memory, which is NHWC storage: the
hand-written kernels take them as NHWC views without a copy.  The flatten
before ``output_layer.3`` is NCHW as upstream (``fvt_tpu`` flattens NHWC
and the weight bridge permutes the Linear's columns to match).

The mode is the forward's ``train`` argument, not the module's:
``nn.Module.training`` is read nowhere, so ``.train()`` changes no output
and moves no statistic.  Eval (the default): every BatchNorm runs on its
running statistics through :func:`batchnorm_eval` and dropout is the
identity.  Train, the frozen backbone of ``fvt_tpu``'s training step
(``fvt_tpu/models/models.py:28-67``: the encoders train with the model,
their parameters get no gradient): every BatchNorm runs on the batch's
statistics and updates the running ones (:func:`batchnorm_train`), and
Dropout(0.4) acts on ``output_layer.0``'s output before the flatten, its
mask drawn from the caller's generator (:func:`dropout_train`).  The whole
train forward runs under ``torch.no_grad``: the input is data and no
parameter trains, so nothing is differentiated through it and the
kernel paths' ``refuse_grad`` does not fire.  The convolutions take the
paths they take in eval; ``fused_blocks`` raises in train mode, since
the fused block folds the running statistics into its affines.  The
dropout mask lies in the port's NCHW layout, so it is not ``fvt_tpu``'s
NHWC mask element by element even from equal bits (and the bits are
PyTorch's, not JAX's).

The 3x3 convolutions of the body have a selectable path
(:data:`CONV_IMPLS`), the counterpart of ``fvt_tpu``'s
``VisualBackbone(conv_impl=...)``; ``fused_blocks`` routes the stride-1
blocks whose widths agree through the fused whole-block kernel, as
``arcface_forward_eval(fused_blocks=True)`` does there.  The defaults,
``'cudnn'`` and ``fused_blocks=False``, are PyTorch's own ``conv2d``.

``dtype`` is the compute type of everything before the flatten, the
counterpart of ``fvt_tpu``'s ``VisualBackbone(dtype=...)``:
``torch.float32`` (default) or ``torch.bfloat16``, which is what ``--amp``
means there (``fvt_tpu/experiment.py:166-184``).  Parameters and running
statistics stay float32 whatever the ``dtype`` (flax keeps them so,
``fvt_tpu/models/arcface.py:48-50``); the input is cast to ``dtype``
first, the convolutions run on copies of their weights in ``dtype``
(derived once and kept, as the other derived weights), BatchNorm2d, PReLU
and the residual adds run on ``dtype`` activations, and the flatten casts
back to float32 before ``output_layer``'s Linear and BatchNorm1d, so the
embeddings are float32.  The ``'shifted_kernel'`` path launches a
tensor-core kernel in either type (``ops/conv.py``): split TF32 at float32
accuracy, or bfloat16, and so does ``fused_blocks`` (``ops/bottleneck.py``:
two launches of the split-TF32 conv kernel, or of a bfloat16 block kernel
of its own), and ``'winograd_kernel'``
(``ops/winograd.py``): split TF32, or a bfloat16 product with the output
transform in its epilogue.  Where the two
frameworks round differently: flax normalises in ``dtype`` (the
subtraction, the product and the sum each round to bfloat16), while
``F.batch_norm`` on a bfloat16 tensor with float32 statistics computes
in float32 and rounds once (the int8 path's bn1 before a quantised conv
is the exception: its quantisation pass normalises as flax does,
:func:`bn_terms`); ``F.conv2d`` and the kernel sum in float32
and round once, as XLA's convolution and the Pallas kernel do; the fused
block rounds where the Pallas block does (``ops.bottleneck.
bottleneck_ir_fused_bf16_ref``), and both Winograd paths where
``fvt_tpu``'s Winograd does (``ops.winograd.conv3x3_winograd_bf16_ref``:
U from the bfloat16 kernel, V in bfloat16 with every add rounded, float32
products and output transform, one rounding of y).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fvt_tpu_torch.models.layers import init_linear_, stamp as _stamp
from fvt_tpu_torch.ops import bottleneck as bottleneck_ops
from fvt_tpu_torch.ops import conv as conv_ops
from fvt_tpu_torch.ops import quant as quant_ops
from fvt_tpu_torch.ops import winograd as winograd_ops
from fvt_tpu_torch.parallel import collectives

# 'cudnn': PyTorch's conv2d (default).  'winograd': the plain PyTorch
# Winograd F(2x2, 3x3), transform-domain tensors in device memory.
# 'winograd_kernel': the Winograd CUDA kernels (float32: input transform,
# split-TF32 product on the tensor cores, output transform; bfloat16: input
# transform, then the product with the output transform in its epilogue).
# 'shifted_kernel': the nine-shifted-products CUDA kernel.  'int8': the
# convs with at least 128 input channels, at any stride, quantised to int8
# (ops/quant.py: the quantise and s8 conv kernels), the others on conv2d.
CONV_IMPLS = ('cudnn', 'winograd', 'winograd_kernel', 'shifted_kernel',
              'int8')
DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype: torch.dtype) -> None:
    """Raises for a compute type the backbone does not take; every conv
    path, fused or not, has a route for both that it takes."""
    if dtype not in DTYPES:
        raise ValueError(f'dtype {dtype}: the backbone computes in '
                         f'torch.float32 or torch.bfloat16')


def get_blocks_50() -> List[Tuple[int, int, int]]:
    """(in_channel, depth, stride) per bottleneck (``arcface.py:89-97``)."""
    blocks = []
    for in_c, depth, num_units, stride in [(64, 64, 3, 1), (64, 128, 4, 2),
                                           (128, 256, 14, 2),
                                           (256, 512, 3, 2)]:
        blocks.append((in_c, depth, stride))
        blocks.extend([(depth, depth, 1)] * (num_units - 1))
    return blocks


def cast_cached(mod: nn.Module, name: str, dtype: torch.dtype
                ) -> torch.Tensor:
    """``getattr(mod, name)`` in ``dtype``: the tensor itself if it has
    that type, else a copy kept on ``mod`` and made again when the tensor
    is replaced or written in place."""
    t = getattr(mod, name)
    if t.dtype == dtype:
        return t
    cache = mod.__dict__.setdefault('_cast_cache', {})
    stamp, hit = _stamp(t), cache.get((name, dtype))
    if hit is None or hit[0] != stamp:
        hit = cache[(name, dtype)] = (stamp, t.detach().to(dtype))
    return hit[1]


def conv2d_as(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` (no bias) with the float32 weight in x's type."""
    return F.conv2d(x, cast_cached(conv, 'weight', x.dtype), None,
                    conv.stride, conv.padding)


def prelu_as(prelu: nn.PReLU, x: torch.Tensor) -> torch.Tensor:
    """``prelu(x)`` with the float32 slopes in x's type, as ``fvt_tpu``'s
    PReLU applies them (``layers.py:214``)."""
    return F.prelu(x, cast_cached(prelu, 'weight', x.dtype))


def batchnorm_eval(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor
                   ) -> torch.Tensor:
    """``bn(x)`` in eval mode whatever ``bn.training`` says: the running
    statistics normalise and none of them moves (the same call that
    ``bn`` makes in eval mode, so the same bits)."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


def batchnorm_train(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor
                    ) -> torch.Tensor:
    """``bn`` in train mode on x (N, C, ...) in its compute type, as
    ``fvt_tpu``'s ``TorchEMABatchNorm`` does it (``layers.py:160-182``):
    the batch mean and the biased variance in float32 as ``mean(x^2) -
    mean(x)^2`` over every axis but C; the running mean and the unbiased
    running variance (``n / (n - 1)``) updated at torch momentum
    ``bn.momentum`` (0.1, flax's 0.9); then ``(x - mean) * (rsqrt(var +
    eps) * weight) + bias`` in x's type, with mean, variance, eps, weight
    and bias cast to it first, so that in bfloat16 every step rounds
    where flax's does.  ``F.batch_norm(training=True)`` is not used: it
    computes the variance by another algorithm and, on bfloat16, in
    float32 with one rounding."""
    red = [0] + list(range(2, x.dim()))
    n = x.numel() // x.shape[1]
    xf = x.float()
    if collectives.current() is None:
        mean = xf.mean(red)
        var = xf.square().mean(red) - mean.square()
    else:  # a sharded data-parallel step: the moments of every rank's frames
        s1, s2, n = collectives.moments(xf, red)
        mean = s1 / n
        var = s2 / n - mean.square()
    del xf
    m = bn.momentum
    with torch.no_grad():
        bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1.0 - m) * bn.running_var
                             + m * (var * (n / max(n - 1, 1))))
        bn.num_batches_tracked += 1
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean, inv, bias = (t.view(shape) for t in bn_terms(bn, mean, var,
                                                        x.dtype))
    return (x - mean) * inv + bias


def bn_terms(bn: nn.modules.batchnorm._BatchNorm, mean: torch.Tensor,
             var: torch.Tensor, d: torch.dtype) -> tuple:
    """(mean, inv, bias) per channel in type ``d``, ``fvt_tpu``'s
    ``TorchEMABatchNorm`` normalising with these statistics
    (``layers.py:180-182``): ``inv = rsqrt(var + eps) * weight`` with
    var, eps and weight in ``d`` first; the BatchNorm is then ``((x -
    mean) * inv) + bias``, each step in ``d``."""
    # a tensor in d, not a Python float: PyTorch would add a scalar in
    # float32 before rounding, flax adds eps in bfloat16
    eps = torch.tensor(bn.eps, dtype=d, device=mean.device)
    # rsqrt in float32, rounded once: XLA's bfloat16 rsqrt is that, and
    # PyTorch's on the CPU misses the nearest bfloat16 by a unit
    inv = torch.rsqrt((var.to(d) + eps).float()).to(d) * bn.weight.to(d)
    return mean.to(d), inv, bn.bias.to(d)


def dropout_mask(x: torch.Tensor, p: float,
                 generator: torch.Generator) -> torch.Tensor:
    """The keep mask (bool, x's shape) of a dropout at rate ``p`` on x,
    drawn from ``generator`` (on x's device)."""
    if generator is None:
        raise ValueError('dropout in train mode draws from an explicit '
                         'torch.Generator')
    # in a sharded data-parallel step: the global batch's mask, this
    # rank's frames of it
    n, lo, hi = collectives.rows(x.shape[0])
    keep = torch.rand((n,) + tuple(x.shape[1:]), generator=generator,
                      device=x.device) < 1.0 - p
    return keep if n == x.shape[0] else keep[lo:hi]


def dropout_train(x: torch.Tensor, p: float,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's ``nn.Dropout(p)`` in train mode on x: ``where(keep, x /
    (1 - p), 0)`` with the mask of :func:`dropout_mask`, the identity at
    ``p == 0`` (no draw).  ``1 - p`` is cast to x's type first, as JAX
    casts the Python float."""
    if p == 0.0:
        return x
    keep = dropout_mask(x, p, generator)
    scale = torch.tensor(1.0 - p, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """The NHWC view of an NCHW tensor (no copy from channels_last)."""
    return x.permute(0, 2, 3, 1).contiguous()


class Conv3x3(nn.Module):
    """3x3 'same' convolution without bias, with a selectable path.

    The parameter is ``weight`` in OIHW, as ``nn.Conv2d``'s, so upstream
    checkpoints and the weight bridge load unchanged.  As in ``fvt_tpu``
    (``arcface.py:76``), only a stride-1 convolution takes a path other
    than ``'cudnn'``.  Those paths take no gradient (the train-mode
    backbone runs without autograd) and take the kernel in
    HWIO (and, for Winograd, its transform ``G g G^T``, packed for the
    ``'winograd_kernel'`` path's CUDA kernel): all are derived from
    ``weight`` at the first call and kept; they are dropped and
    derived again when ``weight`` is replaced or written in place
    (``load_state_dict``, ``.to()``, an optimizer step, a re-init).  So
    are the copies in ``dtype`` that the module computes with (OIHW for
    ``F.conv2d`` in bfloat16, HWIO for the plain version, packed for the
    ``'shifted_kernel'`` path's CUDA kernel; in bfloat16 the Winograd U is
    derived from the bfloat16 HWIO kernel); ``weight`` stays float32.

    ``'int8'`` is ``fvt_tpu``'s int8 conv (``arcface.py:51-73``): with at
    least ``quant_ops.MIN_CIN`` input channels, at any stride, the conv
    quantises ``weight`` per output channel (:meth:`int8_weights`, kept as
    the other derived weights, with their packing for the s8 kernel) and
    its input per tensor, and sums in int32
    (``quant_ops.quantize_int8`` and ``conv3x3_s8``), the output in
    ``dtype``; with fewer it runs ``F.conv2d``.  In eval mode
    ``BottleneckIR`` hands a quantised conv its producer's input and the
    producer as a ``prologue`` (bn1 or PReLU), which the quantisation pass
    applies as it loads x.  The input's scale is the
    call's own ``max|x|`` (dynamic), or ``act_scale(act_amax)`` once
    ``act_amax`` holds a calibrated amax (static).  While ``calibrating``
    the module records the running ``max|x|`` of its inputs into
    ``act_amax`` and its output still takes the dynamic scale, as flax's
    ``sow('act_scales', 'amax', ...)`` does.  ``act_amax`` is no buffer:
    the state_dict is that of every other path.
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 impl: str = 'cudnn', dtype: torch.dtype = torch.float32):
        super().__init__()
        if impl not in CONV_IMPLS:
            raise ValueError(f'unknown conv impl: {impl!r}')
        check_dtype(dtype)
        self.stride = stride
        self.impl = impl
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, 3, 3))
        self._derived = None
        self._cast = None
        self._int8 = None
        self.calibrating = False
        self.act_amax: Optional[torch.Tensor] = None
        self._static = None

    @property
    def quantised(self) -> bool:
        """True where the ``'int8'`` path quantises this conv."""
        return (self.impl == 'int8'
                and self.weight.shape[1] >= quant_ops.MIN_CIN)

    def int8_weights(self) -> tuple:
        """(wq (Co, 9, C) int8, wscale (Co,) float32, wq packed for the s8
        conv kernel): ``quant_ops.quantize_weights`` of the float32 HWIO
        kernel, as ``fvt_tpu`` quantises its float32 parameter, and
        ``quant_ops.pack_weights_s8`` of wq; cached as the class docstring
        says."""
        stamp = _stamp(self.weight)
        if self._int8 is None or self._int8[0] != stamp:
            with torch.no_grad():
                wq, wscale = quant_ops.quantize_weights(
                    self.weight.detach().permute(2, 3, 1, 0))
                self._int8 = (stamp, (wq, wscale,
                                      quant_ops.pack_weights_s8(wq)))
        return self._int8[1]

    def static_scale(self, device) -> Optional[torch.Tensor]:
        """``act_scale(act_amax)`` on ``device`` (kept), or None while
        calibrating or without a calibrated amax."""
        if self.calibrating or self.act_amax is None:
            return None
        amax = self.act_amax
        if (self._static is None or self._static[0] is not amax
                or self._static[1] != device):
            self._static = (amax, device,
                            quant_ops.act_scale(amax.to(device)))
        return self._static[2]

    def _int8_forward(self, x: torch.Tensor, reference: bool,
                      prologue: Optional[tuple]) -> torch.Tensor:
        conv_ops.refuse_grad('Conv3x3(impl=\'int8\')', x, self.weight)
        wq, wscale, packed = self.int8_weights()
        quantize = (quant_ops.quantize_int8_ref if reference
                    else quant_ops.quantize_int8)
        xq, scale, amax = quantize(_nhwc(x), self.static_scale(x.device),
                                   prologue)
        if self.calibrating:
            amax = amax.detach()
            self.act_amax = (amax if self.act_amax is None else
                             torch.maximum(self.act_amax.to(amax.device),
                                           amax))
        if reference:
            y = quant_ops.conv3x3_s8_ref(xq, scale, wq, wscale, self.stride,
                                         self.dtype)
        else:
            y = quant_ops.conv3x3_s8(xq, scale, wq, wscale, self.stride,
                                     self.dtype, packed=packed)
        return y.permute(0, 3, 1, 2)

    def kernel_weights(self) -> tuple:
        """(HWIO kernel (3, 3, Cin, Cout), its Winograd transform U (16,
        Cin, Cout), U packed for the ``'winograd_kernel'`` path's CUDA
        kernel or None on another path or where the kernel does not take
        the widths), in ``dtype``, cached as the class docstring says.
        float32: the kernel is ``weight``'s, U
        ``ops.winograd.transform_weights`` of it, the packing
        ``pack_winograd_weights_tf32``'s pair; bfloat16: the kernel is
        :meth:`cast_weights`' (rounded to bfloat16), U
        ``transform_weights_bf16`` of it (float32 from the bfloat16
        kernel, rounded once), the packing
        ``pack_winograd_weights_bf16``'s."""
        stamp = _stamp(self.weight)
        if self._derived is None or self._derived[0] != stamp:
            with torch.no_grad():
                kernel = self.impl == 'winograd_kernel'
                if self.dtype == torch.bfloat16:
                    hwio = self.cast_weights()[1]
                    u = winograd_ops.transform_weights_bf16(hwio)
                    c, co = hwio.shape[2:]
                    packed = (winograd_ops.pack_winograd_weights_bf16(u)
                              if kernel and not (c % 16 or co % 8)
                              else None)
                else:
                    hwio = self.weight.permute(2, 3, 1, 0).contiguous()
                    c, co = hwio.shape[2:]
                    u = winograd_ops.transform_weights(hwio).reshape(
                        16, c, co)
                    packed = (winograd_ops.pack_winograd_weights_tf32(u)
                              if kernel and not (c % 4 or co % 4) else None)
            self._derived = (stamp, hwio, u, packed)
        return self._derived[1:]

    def cast_weights(self) -> tuple:
        """(``weight`` in OIHW, the HWIO kernel, the kernel packed for the
        CUDA kernel of ``dtype`` or None where it does not take the
        widths), all in ``dtype``: what the ``'shifted_kernel'`` path
        computes with (float32: ``ops.conv.pack_weights_tf32``'s pair;
        bfloat16: ``ops.conv.pack_weights``), cached as the class
        docstring says."""
        stamp = _stamp(self.weight)
        if self._cast is None or self._cast[0] != stamp:
            with torch.no_grad():
                oihw = self.weight.detach().to(self.dtype)
                hwio = oihw.permute(2, 3, 1, 0).contiguous()
                co, c = oihw.shape[:2]
                if self.dtype == torch.bfloat16:
                    packed = (None if c % 16 or co % 8
                              else conv_ops.pack_weights(hwio))
                else:
                    packed = (None if c % 4 or co % 4
                              else conv_ops.pack_weights_tf32(hwio))
            self._cast = (stamp, oihw, hwio, packed)
        return self._cast[1:]

    def forward(self, x: torch.Tensor, reference: bool = False,
                prologue: Optional[tuple] = None) -> torch.Tensor:
        """x NCHW, cast to ``dtype`` (``fvt_tpu`` ``arcface.py:75``).
        ``reference=True`` runs a kernel's plain version.  ``prologue``
        (a quantised conv only, ``quant_ops.prologue_ref``): the producer
        of the conv's input, applied as the quantisation pass loads x."""
        x = x.to(self.dtype)
        if self.quantised:
            return self._int8_forward(x, reference, prologue)
        if prologue is not None:
            raise ValueError('a prologue is applied by the quantisation '
                             'pass: this conv is not quantised')
        if self.stride != 1 or self.impl in ('cudnn', 'int8'):
            weight = (self.weight if self.dtype == self.weight.dtype
                      else self.cast_weights()[0])
            return F.conv2d(x, weight, None, self.stride, 1)
        conv_ops.refuse_grad(f'Conv3x3(impl={self.impl!r})', x, self.weight)
        if self.impl == 'shifted_kernel':
            _, hwio, packed = self.cast_weights()
            if reference:
                y = conv_ops.conv3x3_ref(_nhwc(x), hwio)
            else:
                y = conv_ops.conv3x3(_nhwc(x), hwio, packed=packed)
        else:
            hwio, u, packed = self.kernel_weights()
            if reference or self.impl == 'winograd':
                ref = (winograd_ops.conv3x3_winograd_bf16_ref
                       if self.dtype == torch.bfloat16
                       else winograd_ops.conv3x3_winograd_ref)
                y = ref(_nhwc(x), hwio, u)
            else:
                y = winograd_ops.conv3x3_winograd(_nhwc(x), hwio, u,
                                                  packed=packed)
        return y.permute(0, 3, 1, 2)


class BottleneckIR(nn.Module):
    """BN -> 3x3 conv -> PReLU -> 3x3 strided conv -> BN, + shortcut."""

    def __init__(self, in_channel: int, depth: int, stride: int,
                 conv_impl: str = 'cudnn',
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_dtype(dtype)
        self.stride = stride
        self.dtype = dtype
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
            Conv3x3(in_channel, depth, 1, conv_impl, dtype),
            nn.PReLU(depth),
            Conv3x3(depth, depth, stride, conv_impl, dtype),
            nn.BatchNorm2d(depth))
        self._fused = None
        self._prologues = None

    def int8_prologues(self) -> tuple:
        """(bn1's prologue, PReLU's) for the quantisation pass of a
        quantised conv1 and conv2 (``quant_ops.prologue_ref``), in the
        block's ``dtype``: ``('bn1', mean, inv, bias)`` of the running
        statistics (:func:`bn_terms`, ``fvt_tpu``'s eval arithmetic) and
        ``('prelu', alpha)``.  Derived once and kept; dropped and derived
        again when a tensor of bn1 or the PReLU weight is replaced or
        written in place."""
        bn1, _, prelu, _, _ = self.res_layer
        stamp = _stamp(prelu.weight, bn1.weight, bn1.bias, bn1.running_mean,
                       bn1.running_var)
        if self._prologues is None or self._prologues[0] != stamp:
            with torch.no_grad():
                d = self.dtype
                bn = bn_terms(bn1, bn1.running_mean, bn1.running_var, d)
                self._prologues = (stamp, (('bn1', *bn), (
                    'prelu', prelu.weight.detach().to(d))))
        return self._prologues[1]

    def fused_weights(self) -> tuple:
        """(w1, w2, a1, b1, alpha, a2, b2, packed) for the fused block:
        HWIO kernels in the block's ``dtype``, the folded eval BatchNorms
        and the PReLU slopes (float32), and both kernels packed for the
        CUDA kernel of that type (float32: split,
        ``ops.bottleneck.pack_block_weights``; bfloat16: the convs' own
        ``Conv3x3.cast_weights`` packing,
        ``ops.bottleneck.pack_block_weights_bf16``; None where it does not
        take the width).  Derived once and kept; dropped and derived again
        when any parameter or running statistic of the block is replaced
        or written in place."""
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
                if self.dtype == torch.bfloat16:
                    (_, w1, p1), (_, w2, p2) = (conv.cast_weights()
                                                for conv in (conv1, conv2))
                    packed = None if p1 is None else (p1, p2)
                else:
                    w1, w2 = (conv.kernel_weights()[0]
                              for conv in (conv1, conv2))
                    packed = (None if w1.shape[2] % 4
                              else bottleneck_ops.pack_block_weights(w1, w2))
                derived = (w1, w2, *affine[0], prelu.weight.detach(),
                           *affine[1], packed)
            self._fused = (stamp, derived)
        return self._fused[1]

    def forward(self, x: torch.Tensor, *, fused: bool = False,
                reference: bool = False, train: bool = False
                ) -> torch.Tensor:
        """x NCHW, in the block's ``dtype`` as ``Backbone`` hands it.
        ``fused`` takes the whole-block kernel where the block is
        ``fusable``; ``reference=True`` runs the kernels' plain versions;
        ``train=True`` runs bn1, bn2 and the shortcut's BatchNorm on the
        batch's statistics (:func:`batchnorm_train`)."""
        if fused and train:
            raise ValueError('the fused block folds the running '
                             'statistics: it runs in eval mode only')
        bn_fn = batchnorm_train if train else batchnorm_eval
        if fused and self.fusable:
            conv_ops.refuse_grad('BottleneckIR(fused)', x,
                                 *self.res_layer.parameters())
            *args, packed = self.fused_weights()
            if reference:
                ref = (bottleneck_ops.bottleneck_ir_fused_bf16_ref
                       if self.dtype == torch.bfloat16
                       else bottleneck_ops.bottleneck_ir_fused_ref)
                y = ref(_nhwc(x), *args)
            else:
                y = bottleneck_ops.bottleneck_ir_fused(_nhwc(x), *args,
                                                       packed=packed)
            return y.permute(0, 3, 1, 2)
        if self.shortcut_layer is None:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            conv, bn = self.shortcut_layer
            shortcut = bn_fn(bn, conv2d_as(conv, x))
        bn1, conv1, prelu, conv2, bn2 = self.res_layer
        # in eval mode a quantised conv applies its producer (bn1, PReLU)
        # as its quantisation pass loads the producer's input
        fold = not train and (conv1.quantised or conv2.quantised)
        p1, p2 = self.int8_prologues() if fold else (None, None)
        if fold and conv1.quantised:
            h = conv1(x, reference, prologue=p1)
        else:
            h = conv1(bn_fn(bn1, x), reference)
        if fold and conv2.quantised:
            res = conv2(h, reference, prologue=p2)
        else:
            res = conv2(prelu_as(prelu, h), reference)
        return bn_fn(bn2, res) + shortcut


class Backbone(nn.Module):
    def __init__(self, drop_ratio: float = 0.4, conv_impl: str = 'cudnn',
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_dtype(dtype)
        self.dtype = dtype
        self.conv_impl = conv_impl
        # Cin = 3 makes a poor product: the input conv stays on conv2d
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=False), nn.BatchNorm2d(64),
            nn.PReLU(64))
        self.body = nn.ModuleList(
            BottleneckIR(*blk, conv_impl=conv_impl, dtype=dtype)
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
                reference: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x (N, 40, 40, 3) -> (N, 512) float32.  Eval by default
        (running-statistic BatchNorm, no dropout) whatever the modules'
        ``training`` flags say, as ``fvt_tpu``'s ``apply(x)`` is.
        ``train=True``: every BatchNorm on the batch's statistics, the
        running ones updated, and the dropout's mask drawn from
        ``generator``, all under ``torch.no_grad`` (module docstring)."""
        if not train:
            return self._forward(x, fused_blocks, reference, False, None)
        with torch.no_grad():
            return self._forward(x, fused_blocks, reference, True,
                                 generator)

    def _forward(self, x, fused_blocks, reference, train, generator):
        if fused_blocks and self.conv_impl == 'int8':
            raise ValueError(INT8_FUSED)
        x = self.stem(x, train)
        for blk in self.body:
            x = blk(x, fused=fused_blocks, reference=reference, train=train)
        return self.head(x, train, generator)

    def stem(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``input_layer`` on x (N, 40, 40, 3): conv, BatchNorm (on the
        batch's statistics if ``train``), PReLU; NCHW in channels_last
        memory (NHWC storage), in ``dtype``."""
        bn_fn = batchnorm_train if train else batchnorm_eval
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        conv, bn, prelu = self.input_layer
        return prelu_as(prelu, bn_fn(bn, conv2d_as(conv, x)))

    def head(self, x: torch.Tensor, train: bool = False,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``output_layer`` on the body's (N, 512, 5, 5): BatchNorm2d, in
        train mode the dropout (``fvt_tpu`` ``arcface.py:158-159``; eval's
        is the identity), the NCHW flatten cast to float32, Linear,
        BatchNorm1d, then the l2 normalisation: (N, 512) float32."""
        bn_fn = batchnorm_train if train else batchnorm_eval
        bn2d, dropout, flatten, linear, bn1d = self.output_layer
        x = bn_fn(bn2d, x)
        if train:
            x = dropout_train(x, dropout.p, generator)
        x = bn_fn(bn1d, linear(flatten(x).float()))
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


# fvt_tpu's only fused forward, arcface_forward_eval(fused_blocks=True),
# reads no conv_impl and runs every conv in float, and its
# VisualBackbone(conv_impl='int8') has no fused blocks: no int8 fused block
# exists to port
INT8_FUSED = ("conv_impl='int8' with fused_blocks: fvt_tpu has no int8 "
              "fused block (arcface_forward_eval runs its convs in float)")
# device memory an eval forward of the int8 backbone holds a frame, at its
# peak (cuDNN's workspace for stage 1 included), by compute type: an upper
# bound of what chip_smoke.py's phase 13 measures on the card (bytes a
# frame of torch.cuda.max_memory_allocated over a 2400-frame forward:
# 7.06 MiB in float32, 1.08 MiB in bfloat16 on an H100), which fails on a
# bound below it
INT8_FRAME_BYTES = {torch.float32: 8 << 20, torch.bfloat16: 3 << 19}


def free_device_bytes(device) -> Optional[int]:
    """The bytes a call may take on ``device``: on the card its free memory
    plus what PyTorch's cache holds free; None (no bound) elsewhere."""
    if torch.device(device).type != 'cuda':
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free + (torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))


class VisualBackbone(nn.Module):
    """Wrapper holding ``backbone`` (upstream ``backbone.py:69-130``).
    ``conv_impl`` (one of :data:`CONV_IMPLS`) and ``fused_blocks`` (eval
    mode only) pick the path of the body's 3x3 convolutions, ``dtype`` the
    compute type (``torch.bfloat16`` is ``--amp``; the module docstring
    says what runs in it).

    ``conv_impl='int8'`` (``--serve_quant int8 | int8_static``) quantises
    the 41 convs with at least 128 input channels (:meth:`int8_convs`).
    Their calibrated amaxes are ``fvt_tpu``'s ``act_scales`` collection:
    :meth:`act_scales` and :meth:`load_act_scales` carry it under flax's
    paths (``backbone/body<i>/conv<j>/amax``), :meth:`begin_calibration`
    and :meth:`end_calibration` bracket a calibration pass, and
    :meth:`int8_mode` says which of dynamic, static or calibrating the
    convs are in.  Under dynamic int8 the output of a frame depends on the
    whole call (the scale is the call's ``max|x|``), and so do the amaxes a
    calibration records after the first conv: the caller keeps
    ``fvt_tpu``'s call boundaries and asks :meth:`check_whole_call` first.
    ``fused_blocks`` with int8 raises (:data:`INT8_FUSED`)."""

    def __init__(self, conv_impl: str = 'cudnn', fused_blocks: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_dtype(dtype)
        if fused_blocks and conv_impl == 'int8':
            raise ValueError(INT8_FUSED)
        self.fused_blocks = fused_blocks
        self.dtype = dtype
        self.backbone = Backbone(conv_impl=conv_impl, dtype=dtype)

    def int8_convs(self) -> List[Tuple[Tuple[str, ...], Conv3x3]]:
        """((flax path), module) of each quantised conv, in body order:
        ``('backbone', 'body<i>', 'conv1' | 'conv2')``."""
        out = []
        for i, blk in enumerate(self.backbone.body):
            for name, conv in (('conv1', blk.res_layer[1]),
                               ('conv2', blk.res_layer[3])):
                if conv.quantised:
                    out.append((('backbone', f'body{i}', name), conv))
        return out

    def int8_mode(self) -> str:
        """'none' (no int8 conv), 'calibrating', 'static' (calibrated
        amaxes) or 'dynamic'."""
        convs = self.int8_convs()
        if not convs:
            return 'none'
        conv = convs[0][1]
        if conv.calibrating:
            return 'calibrating'
        return 'dynamic' if conv.act_amax is None else 'static'

    def begin_calibration(self) -> None:
        """Drops the amaxes and records new ones from the next forwards."""
        for _, conv in self.int8_convs():
            conv.act_amax, conv.calibrating = None, True

    def end_calibration(self) -> None:
        """Ends recording: the convs serve with the amaxes recorded."""
        for _, conv in self.int8_convs():
            conv.calibrating = False

    def act_scales(self) -> Dict[str, dict]:
        """The recorded amaxes as ``fvt_tpu``'s ``act_scales`` tree of a
        ``VisualBackbone``: ``{'backbone': {'body<i>': {'conv<j>':
        {'amax': 0-d float32 array}}}}``.  Raises if a conv has none."""
        tree: Dict[str, dict] = {}
        for path, conv in self.int8_convs():
            if conv.act_amax is None:
                raise ValueError(f'{"/".join(path)} has no amax: calibrate '
                                 f'first')
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node['amax'] = np.asarray(
                conv.act_amax.detach().to('cpu', torch.float32)
                .reshape(()).numpy())
        return tree

    def load_act_scales(self, tree: dict) -> None:
        """Serves with the amaxes of an ``act_scales`` tree of a
        ``VisualBackbone`` (static int8).  Raises unless the tree holds an
        amax for exactly the quantised convs."""
        convs = self.int8_convs()
        found = set()

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                elif k == 'amax':
                    found.add(path)
                else:
                    raise KeyError(f'{"/".join(path + (k,))}: not an amax')

        walk(tree, ())
        want = {path for path, _ in convs}
        if found != want:
            raise KeyError(f'act_scales: {len(found)} amaxes for {len(want)} '
                           f'quantised convs; missing '
                           f'{sorted(want - found)[:3]}, extra '
                           f'{sorted(found - want)[:3]}')
        for path, conv in convs:
            node = tree
            for k in path:
                node = node[k]
            conv.act_amax = torch.tensor(
                np.asarray(node['amax'], np.float32).reshape(1),
                device=conv.weight.device)
            conv.calibrating = False

    def check_whole_call(self, frames: int, device) -> None:
        """Raises if an eval forward over ``frames`` frames in one call may
        not fit: ``frames * INT8_FRAME_BYTES[dtype]`` against
        :func:`free_device_bytes`."""
        need = frames * INT8_FRAME_BYTES[self.dtype]
        budget = free_device_bytes(device)
        if budget is not None and need > budget:
            raise MemoryError(
                f'{self.int8_mode()} int8 (--serve_quant int8, or the '
                f'calibration of int8_static): one backbone call over '
                f'{frames} frames, fvt_tpu\'s call boundary (the scale is '
                f'the max over every frame of the call), needs about '
                f'{need} bytes ({need / 2 ** 30:.2f} GiB) and {budget} '
                f'bytes ({budget / 2 ** 30:.2f} GiB) are free; it is not '
                f'split, since that would change the result: give it fewer '
                f'frames a call, or serve with int8_static')

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.backbone.reset_parameters(generator)

    def forward(self, x: torch.Tensor, reference: bool = False,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``Backbone.forward`` with this module's ``fused_blocks``."""
        return self.backbone(x, fused_blocks=self.fused_blocks,
                             reference=reference, train=train,
                             generator=generator)


def arcface_forward_eval(model: VisualBackbone, x: torch.Tensor,
                         fused_blocks: bool = False,
                         reference: bool = False,
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Eval forward of ``model`` on x (N, 40, 40, 3) with the fused
    whole-block kernel switched by the call and not by the module, the
    counterpart of ``fvt_tpu``'s ``arcface_forward_eval(...,
    fused_blocks=...)``.  The same math as ``model(x)``, eval whatever
    ``model.training`` says.  There the
    compute type is an argument of the call, because the parameters are;
    here it belongs to the module, so ``dtype`` only asserts it: another
    type than ``model.dtype`` raises."""
    if dtype is not None and dtype != model.dtype:
        raise ValueError(f'dtype {dtype}: the model was built with '
                         f'dtype={model.dtype}')
    with torch.inference_mode():
        return model.backbone(x, fused_blocks=fused_blocks,
                              reference=reference)
