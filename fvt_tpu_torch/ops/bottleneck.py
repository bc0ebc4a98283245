"""Fused eval-mode identity BottleneckIR block: CUDA kernel and plain
version.

Counterpart of ``fvt_tpu/ops/bottleneck_pallas.py::bottleneck_ir_fused``.
One pass over ``x (N, H, W, C)`` computes the whole stride-1 block whose
input and output widths agree,

    bn1 -> conv1 (3x3) -> PReLU -> conv2 (3x3) -> bn2 -> (+ x)

with both BatchNorms folded to per-channel affines (:func:`bn_affine`) and
neither intermediate written to device memory.  conv1's input outside the
image is 0 (bn1 comes before the zero pad) and so is conv2's.  Layouts
follow the JAX package: NHWC activations, HWIO kernels ``(3, 3, C, C)``.

:func:`bottleneck_ir_fused` runs :func:`bottleneck_ir_fused_ref` for a
tensor on the CPU; for a CUDA tensor it launches the kernel of
``csrc/bottleneck.cu`` or raises (it takes every shape whose tile fits in
shared memory, see :func:`choose_tile`; there is no other path).
``bottleneck_ir_fused.launches`` counts kernel launches.  Eval only.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fvt_tpu_torch.kernels import build
from fvt_tpu_torch.ops.conv import refuse_grad

BN_EPS = 1e-5
ROW_GROUPS = (16, 8, 4)   # a block's 256 threads: rg row groups of pixels by
                          # 256 / rg column groups of 4 output channels
MAX_SLOTS = 16            # pixels a thread may own
CHUNK = 8                 # input channels staged per step (csrc/bottleneck.cu)
MAX_SMEM_FLOATS = 227 * 1024 // 4


def bn_affine(weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor, eps: float = BN_EPS
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm as per-channel (a, b): y = a * x + b."""
    a = weight / torch.sqrt(var + eps)
    return a, bias - mean * a


def _conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """NHWC, HWIO 3x3 'same' convolution through ``F.conv2d``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def bottleneck_ir_fused_ref(x: torch.Tensor, w1: torch.Tensor,
                            w2: torch.Tensor, a1: torch.Tensor,
                            b1: torch.Tensor, alpha: torch.Tensor,
                            a2: torch.Tensor,
                            b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (same math, same layouts)."""
    u = _conv(x * a1 + b1, w1)
    v = torch.where(u > 0, u, alpha * u)
    return (_conv(v, w2) * a2 + b2 + x).contiguous()


# (H, W, C) -> the tile measured fastest on an NVIDIA H100 at N = 2400
# (``python3 -m fvt_tpu_torch.tools.profile_backbone --bottleneck --tiles``)
MEASURED_TILES = {(40, 40, 64): (1, 10, 20, 16),
                  (20, 20, 128): (1, 10, 10, 16),
                  (10, 10, 256): (1, 5, 10, 16),
                  (5, 5, 512): (1, 5, 5, 4)}


def _max_clipped(extent: int, tile: int) -> int:
    """Rows (or columns) of the largest tile plus its one-pixel halo,
    clipped to the image."""
    return max(min(o + tile + 1, extent) - max(o - 1, 0)
               for o in range(0, extent, tile))


def smem_floats(tf: int, th: int, tw: int, rg: int, c: int) -> int:
    """Shared memory of a block, in floats: the v tile (the tile plus
    halo, all C channels, pixel stride C + 4), the staged slice of the
    input on a two-pixel halo, and a (9, CHUNK, 1024 / rg) weight slice."""
    return (tf * (th + 2) * (tw + 2) * (c + 4)
            + tf * (th + 4) * (tw + 4) * (CHUNK + 4)
            + 9 * CHUNK * 1024 // rg)


def conv1_pixels(tf: int, th: int, tw: int, h: int, w: int) -> int:
    """Pixels conv1 computes in the fullest block: the tile plus its
    halo, clipped to the image, over tf frames."""
    return tf * _max_clipped(h, th) * _max_clipped(w, tw)


@functools.lru_cache(maxsize=None)
def choose_tile(n: int, h: int, w: int, c: int) -> Tuple[int, int, int, int]:
    """(tf, th, tw, rg): the frames by pixels a block of the kernel takes
    and the row groups it deals them to, or raises if no tile of this
    shape fits.  conv1 runs on the tile plus its halo, clipped to the
    image, conv2 on the tile: at most ``16 * rg`` pixels each; the block's
    :func:`smem_floats` must fit in shared memory.  The ArcFace stage
    shapes take :data:`MEASURED_TILES`; any other shape the tile that
    minimises the thread rows computed over both convs times ``rg``,
    counted half as much again where only one block fits an SM, then the
    number of blocks."""
    tile = MEASURED_TILES.get((h, w, c))
    if tile is not None and tile[0] <= n:
        return tile
    best, best_cost = None, None
    for th in range(1, h + 1):
        for tw in range(1, w + 1):
            whole = (th, tw) == (h, w)
            for rg in ROW_GROUPS:
                for tf in range(1, (n if whole else 1) + 1):
                    pixels = conv1_pixels(tf, th, tw, h, w)
                    smem = smem_floats(tf, th, tw, rg, c)
                    if pixels > MAX_SLOTS * rg or smem > MAX_SMEM_FLOATS:
                        break
                    blocks = -(-n // tf) * -(-h // th) * -(-w // tw)
                    rows = -(-pixels // rg) + -(-tf * th * tw // rg)
                    two_fit = 2 * (smem * 4 + 1024) <= 228 * 1024
                    cost = (blocks * rows * rg * (1.0 if two_fit else 1.5),
                            blocks)
                    if best_cost is None or cost < best_cost:
                        best, best_cost = (tf, th, tw, rg), cost
    if best is None:
        raise ValueError(f'bottleneck_ir_fused: no tile of a {h}x{w}x{c} '
                         f'frame fits the kernel\'s shared memory')
    return best


def bottleneck_ir_fused(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                        a1: torch.Tensor, b1: torch.Tensor,
                        alpha: torch.Tensor, a2: torch.Tensor,
                        b2: torch.Tensor,
                        tile: Optional[Tuple[int, int, int, int]] = None
                        ) -> torch.Tensor:
    """x (N, H, W, C) float32; w1, w2 HWIO (3, 3, C, C); a1, b1 the
    affine of bn1, alpha the PReLU slopes, a2, b2 the affine of bn2, all
    (C).  Returns (N, H, W, C), a new tensor.  ``tile`` overrides
    :func:`choose_tile` (for measurements)."""
    refuse_grad('bottleneck_ir_fused', x, w1, w2, a1, b1, alpha, a2, b2)
    if x.device.type == 'cpu':
        return bottleneck_ir_fused_ref(x, w1, w2, a1, b1, alpha, a2, b2)
    if x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x.device}')
    n, h, w, c = x.shape
    if c % 4:
        raise ValueError(f'C {c}: the kernel takes a multiple of 4')
    build.check_tensor('x', x, (n, h, w, c), x.device)
    for name, arr in (('w1', w1), ('w2', w2)):
        build.check_tensor(name, arr, (3, 3, c, c), x.device)
    vecs = (('a1', a1), ('b1', b1), ('alpha', alpha), ('a2', a2), ('b2', b2))
    for name, arr in vecs:
        build.check_tensor(name, arr, (c,), x.device)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    tf, th, tw, rg = tile or choose_tile(n, h, w, c)
    err = build.library().fvt_bottleneck_forward(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        *(arr.data_ptr() for _, arr in vecs), out.data_ptr(), n, h, w, c,
        tf, th, tw, rg, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'bottleneck kernel (N={n}, H={h}, W={w}, C={c}, '
                     f'tile={tf}x{th}x{tw}, row groups={rg})')
    bottleneck_ir_fused.launches += 1
    return out


bottleneck_ir_fused.launches = 0
