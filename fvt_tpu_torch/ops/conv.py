"""3x3 stride-1 'same' convolution as nine shifted products: CUDA kernel
and plain version.

Counterpart of ``fvt_tpu/ops/conv_pallas.py::conv3x3_pallas``.  Layouts
follow the JAX package: activations NHWC ``(N, H, W, C)``, kernel HWIO
``(3, 3, C, Co)``, no bias, zero padding of one pixel, output
``(N, H, W, Co)``.

:func:`conv3x3` runs :func:`conv3x3_ref` for a tensor on the CPU; for a
CUDA tensor it launches the kernel of ``csrc/conv3x3.cu`` or raises.
``conv3x3.launches`` counts kernel launches.  Eval only: the kernel has no
backward, as the Pallas kernel has none.
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
    products over a zero-padded copy of ``x``, summed in tap order."""
    n, h, w, c = x.shape
    co = kernel.shape[3]
    xpad = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = x.new_zeros((n * h * w, co))
    for dy in range(3):
        for dx in range(3):
            xs = xpad[:, dy:dy + h, dx:dx + w, :].reshape(n * h * w, c)
            out.addmm_(xs, kernel[dy, dx])
    return out.reshape(n, h, w, co)


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
            tile: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """x (N, H, W, C) float32, kernel HWIO (3, 3, C, Co).  Returns
    (N, H, W, Co).  ``tile`` overrides :func:`choose_tile` (for
    measurements)."""
    refuse_grad('conv3x3', x, kernel)
    if x.device.type == 'cpu':
        return conv3x3_ref(x, kernel)
    if x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x.device}')
    n, h, w, c = x.shape
    co = kernel.shape[3]
    if c % 4 or co % 4:
        raise ValueError(f'C {c}, Co {co}: the kernel takes multiples of 4')
    build.check_tensor('x', x, (n, h, w, c), x.device)
    build.check_tensor('kernel', kernel, (3, 3, c, co), x.device)
    out = torch.empty((n, h, w, co), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
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
