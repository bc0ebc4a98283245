"""3x3 stride-1 'same' convolution as nine shifted products: CUDA kernels
and plain version.

Counterpart of ``fvt_tpu/ops/conv_pallas.py::conv3x3_pallas``.  Layouts
follow the JAX package: activations NHWC ``(N, H, W, C)``, kernel HWIO
``(3, 3, C, Co)``, no bias, zero padding of one pixel, output
``(N, H, W, Co)``.  Two types, as the Pallas kernel computes in the type
it is handed: float32 throughout, or bfloat16 in (``--amp``), the nine
products summed in float32, one rounding to bfloat16 at the end.

:func:`conv3x3` runs :func:`conv3x3_ref` for a tensor on the CPU.  For a
CUDA tensor it launches a kernel or raises, by ``x.dtype``: float32 goes
to the CUDA-core kernel of ``csrc/conv3x3.cu``, bfloat16 to the tensor-core
(``wgmma``) kernel of ``csrc/conv3x3_wgmma.cu``, and neither ever falls
back to the other or to a library.  ``conv3x3.launches`` counts all kernel
launches, ``conv3x3.launches_bf16`` those of the bfloat16 kernel.  Eval
only: the kernels have no backward, as the Pallas kernel has none.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fvt_tpu_torch.kernels import build

ROW_GROUPS = 16                # pixels of a block are dealt to 16 row groups
SLOTS = (4, 8, 10)             # pixels a thread may own (csrc/conv3x3.cu)


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


def conv3x3(x: torch.Tensor, kernel: torch.Tensor,
            tile: Optional[Tuple[int, int, int]] = None,
            packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, H, W, C) and kernel HWIO (3, 3, C, Co), both float32 or both
    bfloat16.  Returns (N, H, W, Co) in the same type.  ``tile`` overrides
    :func:`choose_tile` of the float32 kernel (for measurements);
    ``packed`` is ``pack_weights(kernel)`` kept by the caller, which the
    bfloat16 kernel reads in place of ``kernel``."""
    refuse_grad('conv3x3', x, kernel)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'x is {x.dtype}: conv3x3 takes float32 or bfloat16')
    if kernel.dtype != x.dtype:
        raise ValueError(f'x is {x.dtype} and kernel {kernel.dtype}: conv3x3 '
                         f'takes both in one type')
    if x.device.type == 'cpu':
        return conv3x3_ref(x, kernel)
    if x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x.device}')
    n, h, w, c = x.shape
    co = kernel.shape[3]
    bf16 = x.dtype == torch.bfloat16
    if bf16 and tile is not None:
        raise ValueError('the bfloat16 kernel takes no tile')
    if bf16 and (c % 16 or co % 8):
        raise ValueError(f'C {c}, Co {co}: the bfloat16 kernel takes C in '
                         f'multiples of 16 and Co in multiples of 8')
    if not bf16 and (c % 4 or co % 4):
        raise ValueError(f'C {c}, Co {co}: the kernel takes multiples of 4')
    build.check_tensor('x', x, (n, h, w, c), x.device, x.dtype)
    build.check_tensor('kernel', kernel, (3, 3, c, co), x.device, x.dtype)
    out = torch.empty((n, h, w, co), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    if bf16:
        bn = column_tile(co)
        if packed is None:
            packed = pack_weights(kernel)
        build.check_tensor(
            'packed', packed, (-(-co // bn), c // 16, 9, 2, bn // 8, 8, 8),
            x.device, x.dtype)
        err = build.library().fvt_conv3x3_bf16_forward(
            x.data_ptr(), packed.data_ptr(), out.data_ptr(), n, h, w, c, co,
            bn, torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, f'conv3x3 bfloat16 kernel (N={n}, H={h}, W={w}, '
                         f'C={c}, Co={co})')
        conv3x3.launches += 1
        conv3x3.launches_bf16 += 1
        return out
    tf, th, tw = tile or choose_tile(n, h, w)
    err = build.library().fvt_conv3x3_forward(
        x.data_ptr(), kernel.data_ptr(), out.data_ptr(), n, h, w, c, co,
        tf, th, tw, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'conv3x3 kernel (N={n}, H={h}, W={w}, C={c}, Co={co}, '
                     f'tile={tf}x{th}x{tw})')
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
conv3x3.launches_bf16 = 0
