"""Fused eval-mode identity BottleneckIR block: CUDA kernels and plain
versions.

Counterpart of ``fvt_tpu/ops/bottleneck_pallas.py::bottleneck_ir_fused``.
For ``x (N, H, W, C)`` it computes the whole stride-1 block whose input
and output widths agree,

    bn1 -> conv1 (3x3) -> PReLU -> conv2 (3x3) -> bn2 -> (+ x)

with both BatchNorms folded to per-channel affines (:func:`bn_affine`).
conv1's input outside the image is 0 (bn1 comes before the zero pad) and
so is conv2's.  Layouts follow the JAX package: NHWC activations, HWIO
kernels ``(3, 3, C, C)``.

:func:`bottleneck_ir_fused` runs its plain version for a tensor on the
CPU (:func:`bottleneck_ir_fused_ref`, or for bfloat16
:func:`bottleneck_ir_fused_bf16_ref`); for a float32 CUDA tensor it
launches ``fvt_bottleneck_tf32x3_forward`` (``csrc/conv3x3_tf32x3.cu``) or
raises: two launches of the split-TF32 ``wgmma`` conv that
``ops.conv.conv3x3`` launches, conv1 with bn1 applied where x is split and
PReLU in its store, into a workspace v in device memory, then conv2 with
bn2 and the residual in its store.  :func:`bottleneck_ir_fused_tf32x3_ref`
emulates what it computes, :func:`bn1_line` what conv1 stages.  For a
bfloat16 CUDA tensor (``--amp``) it launches
``fvt_bottleneck_bf16_wgmma_forward`` (``csrc/bottleneck_bf16_wgmma.cu``)
or raises (:func:`bf16_block_plan`): two launches of a bfloat16 ``wgmma``
kernel of the block's own, conv1 with bn1 applied to each staged slice
while the slice before is multiplied and PReLU in its store, conv2 with
the residual staged by the copy engine and bn2 + x in its store, each
tile's v or y written while the next tile's first slice is multiplied,
with the Pallas kernel's rounding points
(:func:`bottleneck_ir_fused_bf16_ref`).
``bottleneck_ir_fused.launches`` counts its calls on the card, one for
the two launches, ``.launches_fp32`` and ``.launches_bf16`` those of each
type.  Two earlier kernels stay for measurements, on no model path, each
counting its own launches: :func:`bottleneck_ir_fused_bf16_conv`, the
bfloat16 block as two launches of the bfloat16 conv kernel
(``fvt_bottleneck_bf16_forward``, ``csrc/conv3x3_wgmma.cu``, bn1 in a pass
of its own over conv1's staged slice), and :func:`bottleneck_ir_fused_simt`
on the CUDA cores (``csrc/bottleneck.cu``, one launch, v kept in shared
memory).  Eval only.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fvt_tpu_torch.kernels import build
from fvt_tpu_torch.ops import conv as conv_ops
from fvt_tpu_torch.ops.conv import refuse_grad

BN_EPS = 1e-5


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


def bottleneck_ir_fused_bf16_ref(x: torch.Tensor, w1: torch.Tensor,
                                 w2: torch.Tensor, a1: torch.Tensor,
                                 b1: torch.Tensor, alpha: torch.Tensor,
                                 a2: torch.Tensor,
                                 b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on bfloat16 x and kernels, the rounding
    points of the Pallas kernel (``bottleneck_pallas.py:137-166``), not
    of its no-tile fallback: conv1's input is ``a1*x + b1`` in float32,
    rounded to bfloat16 once, and 0 outside the image; both convs sum
    their exact products in float32 (``ops.conv.conv3x3_ref``); conv1's
    sums go through PReLU unrounded and v is rounded once; conv2's store is
    ``(acc*a2 + b2) + x`` in float32, rounded once.  a1, b1, alpha, a2, b2
    float32."""
    v = bottleneck_bf16_conv1_ref(x, w1, a1, b1, alpha)
    return bottleneck_bf16_conv2_ref(v, x, w2, a2, b2)


def bottleneck_bf16_conv1_ref(x: torch.Tensor, w1: torch.Tensor,
                              a1: torch.Tensor, b1: torch.Tensor,
                              alpha: torch.Tensor) -> torch.Tensor:
    """The first launch of the bfloat16 block, plainly: ``v =
    bf16(prelu(conv3x3(bf16(a1*x + b1), w1), alpha))``, the affine and
    PReLU in float32, the conv's exact products summed in float32."""
    t = (x.float() * a1 + b1).to(torch.bfloat16)
    u = conv_ops.conv3x3_ref(t.float(), w1.float())
    return torch.where(u > 0, u, alpha * u).to(torch.bfloat16)


def bottleneck_bf16_conv2_ref(v: torch.Tensor, x: torch.Tensor,
                              w2: torch.Tensor, a2: torch.Tensor,
                              b2: torch.Tensor) -> torch.Tensor:
    """The second launch of the bfloat16 block, plainly: ``y =
    bf16((conv3x3(v, w2)*a2 + b2) + x)`` in float32, rounded once."""
    r = conv_ops.conv3x3_ref(v.float(), w2.float())
    return ((r * a2 + b2) + x.float()).to(torch.bfloat16)


# the split-TF32 conv's row tile and TMA load (kBM, kLoad in
# csrc/wgmma_common.cuh), in padded coordinates
ROW_TILE, LOAD = 256, 128


def bn1_line(x: torch.Tensor, a1: torch.Tensor, b1: torch.Tensor
             ) -> torch.Tensor:
    """conv1's input as the split-TF32 kernel stages it, bn1 applied where
    it splits: the padded line of ``Q = N*(H+1)*(W+1)`` coordinates (per
    frame the rows -1 .. H-1 by the columns -1 .. W-1, so one pad row above
    each frame's image, which is also the pad row below the frame before,
    and one pad column left of each row, which is also the pad right of the
    row before), run on to the last coordinate the last row tile stages,
    by ``ceil(C/8)*8`` channels.  A value is ``a1*x + b1`` where the
    coordinate is an image pixel and exactly 0 elsewhere, by the kernel's
    own test: ``q < Q``, the row and the column on the line not 0, the
    channel below C.  Returns ``(L, ceil(C/8)*8)``, L the staged extent:
    ``(tiles - 1) * ROW_TILE + P``."""
    n, h, w, c = x.shape
    w1, frame = w + 1, (h + 1) * (w + 1)
    q_all = n * frame
    p = -(-(ROW_TILE + 2 * w1 + 2) // LOAD) * LOAD
    tiles = -(-(q_all - (w + 2)) // ROW_TILE)
    q = torch.arange((tiles - 1) * ROW_TILE + p, device=x.device)
    rem = q % frame
    row, col = rem // w1, rem % w1
    pixel = (q < q_all) & (row != 0) & (col != 0)
    at = ((q // frame * h + row - 1) * w + col - 1)[pixel]
    line = x.new_zeros((q.numel(), -(-c // 8) * 8))
    line[pixel, :c] = (x * a1 + b1).reshape(-1, c)[at]
    return line


def bottleneck_ir_fused_tf32x3_ref(x: torch.Tensor, w1: torch.Tensor,
                                   w2: torch.Tensor, a1: torch.Tensor,
                                   b1: torch.Tensor, alpha: torch.Tensor,
                                   a2: torch.Tensor,
                                   b2: torch.Tensor) -> torch.Tensor:
    """What the split-TF32 kernel computes, emulated on float32 tensors:
    conv1 on the image pixels of :func:`bn1_line` (``a1*x + b1``, zero
    padded), both convs as ``ops.conv.conv3x3_tf32x3_ref`` (three TF32
    products, ``lo*lo`` dropped, summed in float32), PReLU, then ``(r*a2 +
    b2) + x``.  The kernel rounds the affines' products and sums apart, as
    here; its sums run in another order (per 8-channel slice, then over
    the slices)."""
    n, h, w, c = x.shape
    t = bn1_line(x, a1, b1)[:n * (h + 1) * (w + 1)]
    t = t.reshape(n, h + 1, w + 1, -1)[:, 1:, 1:, :c]
    u = conv_ops.conv3x3_tf32x3_ref(t, w1)
    v = torch.where(u > 0, u, alpha * u)
    return (conv_ops.conv3x3_tf32x3_ref(v, w2) * a2 + b2 + x).contiguous()


# the column tile of the block's launches: their second accumulator fits
# a thread's registers at 64 output channels only (csrc/conv3x3_tf32x3.cu)
BLOCK_BN = 64


def pack_block_weights(w1: torch.Tensor, w2: torch.Tensor) -> tuple:
    """``((w1_hi, w1_lo), (w2_hi, w2_lo))``: both convs' kernels as the
    split-TF32 kernel reads them at column tiles of :data:`BLOCK_BN`
    (``ops.conv.pack_weights_tf32``).  A module derives them once and
    keeps them; :func:`bottleneck_ir_fused` derives them per call
    otherwise."""
    return tuple(conv_ops.pack_weights_tf32(w, BLOCK_BN) for w in (w1, w2))


# the launches of the CUDA entry, a bit each
CONV1, CONV2 = 1, 2
BOTH = CONV1 | CONV2


def _check_call(name: str, x: torch.Tensor, *rest: torch.Tensor) -> None:
    refuse_grad(name, x, *rest)
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no kernel for device {x.device}')
    if x.device.type == 'cuda' and x.shape[3] % 4:
        raise ValueError(f'C {x.shape[3]}: {name} takes a multiple of 4')


def pack_block_weights_bf16(w1: torch.Tensor, w2: torch.Tensor) -> tuple:
    """``(w1_packed, w2_packed)``: both bfloat16 convs' kernels as the
    bfloat16 conv kernel reads them (``ops.conv.pack_weights``, column
    tiles of ``ops.conv.column_tile(C)``), what ``Conv3x3`` keeps for its
    own launches in bfloat16.  Both bfloat16 block kernels read this
    packing."""
    return conv_ops.pack_weights(w1), conv_ops.pack_weights(w2)


# the bfloat16 block kernel's (csrc/bottleneck_bf16_wgmma.cu): staged
# coordinates a slice at most, the barriers and the staged rows' alignment
# ahead of the rest of its shared memory
BF16_MAX_P, BF16_HEAD = 512, 256 + 1024
MAX_SMEM = 227 * 1024


def bf16_block_plan(n: int, h: int, w: int, c: int) -> dict:
    """The bfloat16 block kernel's launch for x (N, H, W, C), as its C
    entry computes it (``csrc/bottleneck_bf16_wgmma.cu`` block_plan):
    ``bn`` the column tile (``ops.conv.column_tile(C)``: 64 up to C = 64,
    then 128), ``p`` the staged coordinates a slice (``ROW_TILE + 2*(W+1)
    + 2`` rounded up to ``LOAD``, at most ``BF16_MAX_P``), ``loads`` a
    chunk, ``slots`` in the ring (4 at bn 64, 3 at 128), ``q`` the padded
    coordinates, ``rows`` from the first pixel (W + 2 into the line), the
    column tiles ``n_tiles`` and ``tiles``, ``vec_floats`` (bn1's or bn2's
    vectors and alpha, padded to the column tiles) and ``smem_bytes`` (the
    barriers and alignment, the staged output rows ``ROW_TILE x bn``, the
    ring, the vectors; at most 227 KB).  Raises ValueError where the
    kernel refuses: C not a multiple of 16, frames wider than 126, or N,
    H, W past int indices."""
    if n <= 0 or h <= 0 or w <= 0 or c <= 0 or c % 16:
        raise ValueError(f'C {c} (N={n}, H={h}, W={w}): the bfloat16 block '
                         f'takes a multiple of 16')
    bn = conv_ops.column_tile(c)
    slots = 4 if bn == 64 else 3
    p = -(-(ROW_TILE + 2 * (w + 1) + 2) // LOAD) * LOAD
    q = n * (h + 1) * (w + 1)
    n_tiles = -(-c // bn)
    vec = 2 * c + 2 * n_tiles * bn
    slot = 2 * p * 16 + 9 * 16 * bn * 2
    smem = BF16_HEAD + ROW_TILE * bn * 2 + slots * slot + 4 * vec
    if p > BF16_MAX_P or smem > MAX_SMEM:
        raise ValueError(f'W {w} (C={c}): the bfloat16 block stages {p} '
                         f'coordinates a slice; it takes up to '
                         f'{BF16_MAX_P} (W <= 126) within {MAX_SMEM} bytes '
                         f'of shared memory')
    if q > 2 ** 31 - 1 - 4096:
        raise ValueError(f'N*(H+1)*(W+1) = {q}: past the bfloat16 block\'s '
                         f'int indices')
    rows = q - (w + 2)
    return {'bn': bn, 'p': p, 'loads': p // LOAD, 'slots': slots, 'q': q,
            'rows': rows, 'n_tiles': n_tiles,
            'tiles': -(-rows // ROW_TILE) * n_tiles, 'vec_floats': vec,
            'smem_bytes': smem}


def _check_bf16(x: torch.Tensor, packed: tuple, vecs: tuple,
                v: torch.Tensor, out: torch.Tensor) -> None:
    n, h, w, c = x.shape
    bn = conv_ops.column_tile(c)
    bf16 = torch.bfloat16
    shape = (-(-c // bn), c // 16, 9, 2, bn // 8, 8, 8)
    tensors = [('x', x, (n, h, w, c), bf16), ('v', v, (n, h, w, c), bf16),
               ('out', out, (n, h, w, c), bf16)]
    tensors += [(f'packed w{i + 1}', t, shape, bf16)
                for i, t in enumerate(packed)]
    tensors += [(name, t, (c,), torch.float32) for name, t in zip(
        ('a1', 'b1', 'alpha', 'a2', 'b2'), vecs)]
    for name, t, want, dtype in tensors:
        build.check_tensor(name, t, want, x.device, dtype)


def launch_bf16(x: torch.Tensor, packed: tuple, vecs: tuple,
                v: torch.Tensor, out: torch.Tensor,
                stages: int = BOTH) -> None:
    """Launches the ``stages`` of the bfloat16 block kernel
    (``fvt_bottleneck_bf16_wgmma_forward``) on the current stream: conv1
    x -> v (bn1, PReLU), conv2 v -> out (bn2, + x), x, v and out
    bfloat16.  ``packed`` as :func:`pack_block_weights_bf16` returns it,
    ``vecs`` ``(a1, b1, alpha, a2, b2)`` float32.  Checks every tensor,
    raises where :func:`bf16_block_plan` refuses and on a CUDA error;
    counts nothing (a measurement may launch one conv alone)."""
    n, h, w, c = x.shape
    bf16_block_plan(n, h, w, c)
    _check_bf16(x, packed, vecs, v, out)
    err = build.library().fvt_bottleneck_bf16_wgmma_forward(
        x.data_ptr(), *(t.data_ptr() for t in packed),
        *(t.data_ptr() for t in vecs), v.data_ptr(), out.data_ptr(), n, h,
        w, c, stages, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'bottleneck bfloat16 kernel (N={n}, H={h}, W={w}, '
                     f'C={c}, stages={stages})')


def launch_bf16_conv(x: torch.Tensor, packed: tuple, vecs: tuple,
                     v: torch.Tensor, out: torch.Tensor,
                     stages: int = BOTH) -> None:
    """:func:`launch_bf16` on the earlier design, two launches of the
    bfloat16 conv kernel (``fvt_bottleneck_bf16_forward``,
    ``csrc/conv3x3_wgmma.cu``): the same arguments, tensors and result.
    Counts nothing."""
    n, h, w, c = x.shape
    _check_bf16(x, packed, vecs, v, out)
    err = build.library().fvt_bottleneck_bf16_forward(
        x.data_ptr(), *(t.data_ptr() for t in packed),
        *(t.data_ptr() for t in vecs), v.data_ptr(), out.data_ptr(), n, h,
        w, c, conv_ops.column_tile(c), stages,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'bottleneck bfloat16 conv kernel (N={n}, H={h}, '
                     f'W={w}, C={c}, stages={stages})')


def launch_tf32x3(x: torch.Tensor, packed: tuple, vecs: tuple,
                  v: torch.Tensor, out: torch.Tensor,
                  stages: int = BOTH) -> None:
    """Launches the ``stages`` of the split-TF32 block on the current
    stream: conv1 x -> v (bn1, PReLU), conv2 v -> out (bn2, + x).
    ``packed`` as :func:`pack_block_weights` returns it, ``vecs`` ``(a1,
    b1, alpha, a2, b2)``.  Checks every tensor and raises on a CUDA error;
    counts nothing (a measurement may launch one conv alone)."""
    n, h, w, c = x.shape
    bn = BLOCK_BN
    shape = (-(-c // bn), -(-c // 8), 9, 2, bn // 8, 8, 4)
    tensors = [('x', x, (n, h, w, c)), ('v', v, (n, h, w, c)),
               ('out', out, (n, h, w, c))]
    tensors += [(f'packed w{i + 1} {part}', t, shape)
                for i, pair in enumerate(packed)
                for part, t in zip(('hi', 'lo'), pair)]
    tensors += [(name, t, (c,)) for name, t in zip(
        ('a1', 'b1', 'alpha', 'a2', 'b2'), vecs)]
    for name, t, want in tensors:
        build.check_tensor(name, t, want, x.device)
    err = build.library().fvt_bottleneck_tf32x3_forward(
        x.data_ptr(), *(t.data_ptr() for pair in packed for t in pair),
        *(t.data_ptr() for t in vecs), v.data_ptr(), out.data_ptr(), n, h,
        w, c, bn, stages, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'bottleneck split-TF32 kernel (N={n}, H={h}, W={w}, '
                     f'C={c}, stages={stages})')


def bottleneck_ir_fused(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                        a1: torch.Tensor, b1: torch.Tensor,
                        alpha: torch.Tensor, a2: torch.Tensor,
                        b2: torch.Tensor,
                        packed: Optional[tuple] = None) -> torch.Tensor:
    """x (N, H, W, C) float32 or bfloat16; w1, w2 HWIO (3, 3, C, C) in x's
    type; a1, b1 the affine of bn1, alpha the PReLU slopes, a2, b2 the
    affine of bn2, all (C) float32.  Returns (N, H, W, C) in x's type, a
    new tensor.  ``packed``: ``pack_block_weights(w1, w2)`` (float32) or
    ``pack_block_weights_bf16(w1, w2)`` (bfloat16) when the caller keeps
    it, read in place of w1 and w2; derived here otherwise.  On the card
    the workspace v (N, H, W, C) comes from the caching allocator."""
    _check_call('bottleneck_ir_fused', x, w1, w2, a1, b1, alpha, a2, b2)
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == 'cpu':
        ref = bottleneck_ir_fused_bf16_ref if bf16 else bottleneck_ir_fused_ref
        return ref(x, w1, w2, a1, b1, alpha, a2, b2)
    if bf16:
        if x.numel():  # the shapes the kernel refuses raise here
            bf16_block_plan(*x.shape)
        out = _bf16_block(x, w1, w2, (a1, b1, alpha, a2, b2), packed,
                          launch_bf16)
        if x.numel():
            bottleneck_ir_fused.launches += 1
            bottleneck_ir_fused.launches_bf16 += 1
        return out
    if packed is None:
        c = x.shape[3]
        for name, k in (('w1', w1), ('w2', w2)):
            build.check_tensor(name, k, (3, 3, c, c), x.device)
        packed = pack_block_weights(w1, w2)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    launch_tf32x3(x, packed, (a1, b1, alpha, a2, b2), torch.empty_like(x),
                  out)
    bottleneck_ir_fused.launches += 1
    bottleneck_ir_fused.launches_fp32 += 1
    return out


bottleneck_ir_fused.launches = 0
bottleneck_ir_fused.launches_fp32 = 0
bottleneck_ir_fused.launches_bf16 = 0


def _bf16_block(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                vecs: tuple, packed: Optional[tuple],
                launch) -> torch.Tensor:
    """A new y: the bfloat16 block on the card through ``launch``
    (nothing launched for an empty x).  Raises for C not a multiple of 16
    before packing anything."""
    c = x.shape[3]
    if c % 16:
        raise ValueError(f'C {c}: the bfloat16 block takes a multiple of 16')
    if packed is None:
        for name, k in (('w1', w1), ('w2', w2)):
            build.check_tensor(name, k, (3, 3, c, c), x.device, x.dtype)
        packed = pack_block_weights_bf16(w1, w2)
    out = torch.empty_like(x)
    if x.numel():
        launch(x, packed, vecs, torch.empty_like(x), out)
    return out


def bottleneck_ir_fused_bf16_conv(x: torch.Tensor, w1: torch.Tensor,
                                  w2: torch.Tensor, a1: torch.Tensor,
                                  b1: torch.Tensor, alpha: torch.Tensor,
                                  a2: torch.Tensor, b2: torch.Tensor,
                                  packed: Optional[tuple] = None
                                  ) -> torch.Tensor:
    """The earlier design of :func:`bottleneck_ir_fused`'s bfloat16 route,
    two launches of the bfloat16 conv kernel (:func:`launch_bf16_conv`),
    on no path, kept to be timed beside it: the same arguments (x
    bfloat16) and result; the plain version on the CPU;
    ``bottleneck_ir_fused_bf16_conv.launches`` counts its calls."""
    _check_call('bottleneck_ir_fused_bf16_conv', x, w1, w2, a1, b1, alpha,
                a2, b2)
    if x.dtype != torch.bfloat16:
        raise ValueError(f'bottleneck_ir_fused_bf16_conv takes bfloat16, '
                         f'not {x.dtype}')
    if x.device.type == 'cpu':
        return bottleneck_ir_fused_bf16_ref(x, w1, w2, a1, b1, alpha, a2, b2)
    out = _bf16_block(x, w1, w2, (a1, b1, alpha, a2, b2), packed,
                      launch_bf16_conv)
    if x.numel():
        bottleneck_ir_fused_bf16_conv.launches += 1
    return out


bottleneck_ir_fused_bf16_conv.launches = 0


# the CUDA-core kernel (csrc/bottleneck.cu), bottleneck_ir_fused_simt
ROW_GROUPS = (16, 8, 4)   # a block's 256 threads: rg row groups of pixels by
                          # 256 / rg column groups of 4 output channels
MAX_SLOTS = 16            # pixels a thread may own
CHUNK = 8                 # input channels staged per step (csrc/bottleneck.cu)
MAX_SMEM_FLOATS = 227 * 1024 // 4


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
        raise ValueError(f'bottleneck_ir_fused_simt: no tile of a {h}x{w}x{c} '
                         f'frame fits the kernel\'s shared memory')
    return best


def bottleneck_ir_fused_simt(x: torch.Tensor, w1: torch.Tensor,
                             w2: torch.Tensor, a1: torch.Tensor,
                             b1: torch.Tensor, alpha: torch.Tensor,
                             a2: torch.Tensor, b2: torch.Tensor,
                             tile: Optional[Tuple[int, int, int, int]] = None
                             ) -> torch.Tensor:
    """The earlier fused kernel, on the CUDA cores (``csrc/bottleneck.cu``,
    one launch, v kept in shared memory), kept to be timed beside
    :func:`bottleneck_ir_fused`'s: no model path calls it.  The arguments
    are :func:`bottleneck_ir_fused`'s; ``tile`` overrides
    :func:`choose_tile` (for measurements).  The plain version on the CPU;
    ``bottleneck_ir_fused_simt.launches`` counts its launches."""
    _check_call('bottleneck_ir_fused_simt', x, w1, w2, a1, b1, alpha, a2,
                b2)
    if x.device.type == 'cpu':
        return bottleneck_ir_fused_ref(x, w1, w2, a1, b1, alpha, a2, b2)
    n, h, w, c = x.shape
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
    build.check(err, f'bottleneck SIMT kernel (N={n}, H={h}, W={w}, C={c}, '
                     f'tile={tf}x{th}x{tw}, row groups={rg})')
    bottleneck_ir_fused_simt.launches += 1
    return out


bottleneck_ir_fused_simt.launches = 0
