"""3x3 stride-1 'same' convolution as nine shifted products: CUDA kernels
and plain version.

Counterpart of ``fvt_tpu/ops/conv_pallas.py::conv3x3_pallas``.  Layouts
follow the JAX package: activations NHWC ``(N, H, W, C)``, kernel HWIO
``(3, 3, C, Co)``, no bias, zero padding of one pixel, output
``(N, H, W, Co)``.  Two types, as the Pallas kernel computes in the type
it is handed: float32 throughout, or bfloat16 in (``--amp``), the nine
products summed in float32, one rounding to bfloat16 at the end.

:func:`conv3x3` runs :func:`conv3x3_ref` for a tensor on the CPU.  For a
CUDA tensor it launches a tensor-core (``wgmma``) kernel or raises, by
``x.dtype``: float32 goes to the split-TF32 kernel of
``csrc/conv3x3_tf32x3.cu`` (three TF32 products of the operands' hi and
lo parts, :func:`split_tf32`, at float32 accuracy), bfloat16 to
``csrc/conv3x3_wgmma.cu``, and neither ever falls back to another kernel
or to a library.  ``conv3x3.launches`` counts all its launches,
``conv3x3.launches_fp32`` and ``conv3x3.launches_bf16`` those of each
kernel.  :func:`conv3x3_simt`, the earlier float32 kernel on the CUDA
cores (``csrc/conv3x3.cu``), stays for measurements: no model path calls
it.  Eval only: the kernels have no backward, as the Pallas kernel has
none.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fvt_tpu_torch.kernels import build


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The eval-only kernels have no backward: raises for an input that
    requires grad while grad mode is on."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f'{name} has no backward: call it under '
                           f'torch.no_grad()')


def conv3x3_ref(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the nine shifted ``(N*H*W, C) @ (C, Co)``
    products over a zero-padded copy of ``x``, summed in tap order.  For
    bfloat16 inputs the products (exact in float32) are summed in a float32
    buffer and rounded to bfloat16 once, as the Pallas kernel does."""
    if x.dtype == torch.bfloat16:
        return conv3x3_ref(x.float(), kernel.float()).to(torch.bfloat16)
    n, h, w, c = x.shape
    co = kernel.shape[3]
    xpad = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = x.new_zeros((n * h * w, co))
    for dy in range(3):
        for dx in range(3):
            xs = xpad[:, dy:dy + h, dx:dx + w, :].reshape(n * h * w, c)
            out.addmm_(xs, kernel[dy, dx])
    return out.reshape(n, h, w, co)


def column_tile(co: int) -> int:
    """Output channels a block of the bfloat16 kernel takes."""
    return 64 if co <= 64 else 128


def pack_weights(kernel: torch.Tensor) -> torch.Tensor:
    """The HWIO kernel (3, 3, C, Co), C a multiple of 16 and Co of 8, in
    the layout the bfloat16 kernel copies into shared memory: per column
    tile of ``bn = column_tile(Co)`` output channels and 16-channel slice,
    the nine taps' (16, bn) weights as the 8x8 blocks ``wgmma`` reads.
    Returns ``(tiles, C/16, 9, 2, bn/8, 8, 8)`` with ``packed[t, s, tap, h,
    n8, k, n] = kernel[tap // 3, tap % 3, 16*s + 8*h + k, bn*t + 8*n8 + n]``
    and zeros where the output channel is beyond Co.  A module derives it
    once and keeps it; :func:`conv3x3` derives it per call otherwise."""
    c, co = kernel.shape[2:]
    bn = column_tile(co)
    tiles = -(-co // bn)
    w = F.pad(kernel.reshape(9, c, co), (0, tiles * bn - co))
    w = w.reshape(9, c // 16, 2, 8, tiles, bn // 8, 8)
    return w.permute(4, 1, 0, 2, 5, 3, 6).contiguous()


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``t`` as two TF32 values (10 explicit mantissa bits, the low
    13 bits zero): ``hi`` is ``t`` rounded to nearest, ties away from zero,
    and ``lo`` is ``t - hi`` (exact in float32) rounded the same way, as
    ``cvt.rna.tf32.f32`` rounds in the kernel.  The rounding is bit
    arithmetic on the int32 view: add half of the dropped 13 bits' range to
    the magnitude, clear them.  Non-finite values are their own hi (lo 0)."""
    if t.dtype != torch.float32:
        raise ValueError(f'split_tf32 takes float32, not {t.dtype}')

    def rna(v):
        bits = (v.view(torch.int32) + 0x1000) & ~0x1FFF
        return torch.where(torch.isfinite(v), bits.view(torch.float32), v)

    hi = rna(t)
    lo = torch.where(torch.isfinite(t), rna(t - hi), torch.zeros_like(t))
    return hi, lo


def pack_taps_tf32(w: torch.Tensor, bn: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 weights of ``taps`` shifted products, ``w (taps, C, Co)``,
    as the split-TF32 kernels copy them into shared memory: the ``(hi,
    lo)`` parts of :func:`split_tf32`, each per column tile of ``bn``
    output channels and 8-channel slice, the taps' (8, bn) weights as the
    K-major core matrices (8 output channels x 4 inputs) ``wgmma`` reads.
    Each part is ``(tiles, ceil(C/8), taps, 2, bn/8, 8, 4)`` with
    ``part[t, s, tap, h, n8, n, k] = split(w[tap, 8*s + 4*h + k, bn*t +
    8*n8 + n])``, zeros where the input channel is beyond C or the output
    channel beyond Co."""
    taps, c, co = w.shape
    tiles, slices = -(-co // bn), -(-c // 8)
    w = F.pad(w, (0, tiles * bn - co, 0, slices * 8 - c))
    w = w.reshape(taps, slices, 2, 4, tiles, bn // 8, 8)
    return split_tf32(w.permute(4, 1, 0, 2, 5, 6, 3).contiguous())


def pack_weights_tf32(kernel: torch.Tensor, bn: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 HWIO kernel (3, 3, C, Co), C and Co multiples of 4, as
    the split-TF32 conv kernel reads it: :func:`pack_taps_tf32` of its
    nine taps (tap = 3*dy + dx) at column tiles of ``bn`` output channels
    (``column_tile(Co)`` unless given), each part ``(tiles, ceil(C/8), 9,
    2, bn/8, 8, 4)``.  A module derives them once and keeps them;
    :func:`conv3x3` derives them per call otherwise."""
    c, co = kernel.shape[2:]
    return pack_taps_tf32(kernel.reshape(9, c, co), bn or column_tile(co))


def conv3x3_tf32x3_ref(x: torch.Tensor, kernel: torch.Tensor
                       ) -> torch.Tensor:
    """What the split-TF32 kernel computes, emulated on float32 tensors:
    :func:`conv3x3_ref` of the parts ``hi*hi + hi*lo + lo*hi`` (each
    product exact in float32, the sums in float32), ``lo*lo`` dropped."""
    xh, xl = split_tf32(x)
    kh, kl = split_tf32(kernel)
    return (conv3x3_ref(xh, kl) + conv3x3_ref(xl, kh)) + conv3x3_ref(xh, kh)


def _check_types(name: str, x: torch.Tensor, kernel: torch.Tensor) -> None:
    refuse_grad(name, x, kernel)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'x is {x.dtype}: {name} takes float32 or bfloat16')
    if kernel.dtype != x.dtype:
        raise ValueError(f'x is {x.dtype} and kernel {kernel.dtype}: {name} '
                         f'takes both in one type')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no kernel for device {x.device}')


def conv3x3(x: torch.Tensor, kernel: torch.Tensor,
            packed=None) -> torch.Tensor:
    """x (N, H, W, C) and kernel HWIO (3, 3, C, Co), both float32 or both
    bfloat16.  Returns (N, H, W, Co) in the same type.  ``packed`` is the
    kernel's packed weights kept by the caller, read in place of
    ``kernel``: ``pack_weights_tf32(kernel)`` (a pair) for float32,
    ``pack_weights(kernel)`` for bfloat16."""
    _check_types('conv3x3', x, kernel)
    if x.device.type == 'cpu':
        return conv3x3_ref(x, kernel)
    n, h, w, c = x.shape
    co = kernel.shape[3]
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (c % 16 or co % 8):
        raise ValueError(f'C {c}, Co {co}: the bfloat16 kernel takes C in '
                         f'multiples of 16 and Co in multiples of 8')
    if not bf16 and (c % 4 or co % 4):
        raise ValueError(f'C {c}, Co {co}: the float32 kernel takes C and '
                         f'Co in multiples of 4')
    build.check_tensor('x', x, (n, h, w, c), x.device, x.dtype)
    build.check_tensor('kernel', kernel, (3, 3, c, co), x.device, x.dtype)
    out = torch.empty((n, h, w, co), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    bn = column_tile(co)
    tiles = -(-co // bn)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if bf16:
        if packed is None:
            packed = pack_weights(kernel)
        build.check_tensor(
            'packed', packed, (tiles, c // 16, 9, 2, bn // 8, 8, 8),
            x.device, x.dtype)
        err = build.library().fvt_conv3x3_bf16_forward(
            x.data_ptr(), packed.data_ptr(), out.data_ptr(), n, h, w, c, co,
            bn, stream)
        build.check(err, f'conv3x3 bfloat16 kernel (N={n}, H={h}, W={w}, '
                         f'C={c}, Co={co})')
        conv3x3.launches += 1
        conv3x3.launches_bf16 += 1
        return out
    if packed is None:
        packed = pack_weights_tf32(kernel)
    hi, lo = packed
    for name, part in (('packed hi', hi), ('packed lo', lo)):
        build.check_tensor(name, part,
                           (tiles, -(-c // 8), 9, 2, bn // 8, 8, 4),
                           x.device, x.dtype)
    err = build.library().fvt_conv3x3_tf32x3_forward(
        x.data_ptr(), hi.data_ptr(), lo.data_ptr(), out.data_ptr(), n, h, w,
        c, co, bn, stream)
    build.check(err, f'conv3x3 float32 split-TF32 kernel (N={n}, H={h}, '
                     f'W={w}, C={c}, Co={co})')
    conv3x3.launches += 1
    conv3x3.launches_fp32 += 1
    return out


conv3x3.launches = 0
conv3x3.launches_fp32 = 0
conv3x3.launches_bf16 = 0


# the CUDA-core kernel (csrc/conv3x3.cu), conv3x3_simt
ROW_GROUPS = 16                # pixels of a block are dealt to 16 row groups
SLOTS = (4, 8, 10)             # pixels a thread may own (csrc/conv3x3.cu)


@functools.lru_cache(maxsize=None)
def choose_tile(n: int, h: int, w: int) -> Tuple[int, int, int]:
    """(tf, th, tw): the frames by pixels a block of the kernel takes.  A
    block runs ``16 * r`` pixel slots, ``r`` the smallest of :data:`SLOTS`
    that holds the tile.  The choice minimises an instruction count per
    thread and 16-channel step, summed over the blocks: 576 FMAs per slot
    row (used or not), 3 per staged pixel of the tile plus halo (loads
    that nothing overlaps), and 300 for the weight slice and the
    barriers."""
    best, best_cost = None, None
    for th in range(1, h + 1):
        for tw in range(1, w + 1):
            if th * tw > ROW_GROUPS * SLOTS[-1]:
                break
            for r in SLOTS:
                tf = min(n, ROW_GROUPS * r // (th * tw))
                if tf < 1:
                    continue
                blocks = -(-n // tf) * -(-h // th) * -(-w // tw)
                patch = tf * (th + 2) * (tw + 2)
                cost = blocks * (576 * r + 3 * patch + 300)
                if best_cost is None or cost < best_cost:
                    best, best_cost = (tf, th, tw), cost
    return best


def conv3x3_simt(x: torch.Tensor, kernel: torch.Tensor,
                 tile: Optional[Tuple[int, int, int]] = None
                 ) -> torch.Tensor:
    """The earlier float32 kernel, on the CUDA cores (``csrc/conv3x3.cu``),
    kept to be timed beside :func:`conv3x3`'s: no model path calls it.
    x (N, H, W, C) and kernel HWIO (3, 3, C, Co) float32, C and Co
    multiples of 4; ``tile`` overrides :func:`choose_tile`.  The plain
    version on the CPU; ``conv3x3_simt.launches`` counts its launches."""
    _check_types('conv3x3_simt', x, kernel)
    if x.dtype != torch.float32:
        raise ValueError(f'x is {x.dtype}: conv3x3_simt takes float32')
    if x.device.type == 'cpu':
        return conv3x3_ref(x, kernel)
    n, h, w, c = x.shape
    co = kernel.shape[3]
    if c % 4 or co % 4:
        raise ValueError(f'C {c}, Co {co}: the kernel takes multiples of 4')
    build.check_tensor('x', x, (n, h, w, c), x.device)
    build.check_tensor('kernel', kernel, (3, 3, c, co), x.device)
    out = torch.empty((n, h, w, co), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    tf, th, tw = tile or choose_tile(n, h, w)
    err = build.library().fvt_conv3x3_forward(
        x.data_ptr(), kernel.data_ptr(), out.data_ptr(), n, h, w, c, co,
        tf, th, tw, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'conv3x3_simt kernel (N={n}, H={h}, W={w}, C={c}, '
                     f'Co={co}, tile={tf}x{th}x{tw})')
    conv3x3_simt.launches += 1
    return out


conv3x3_simt.launches = 0
