"""Winograd F(2x2, 3x3) convolution: CUDA kernels and plain versions.

Counterpart of ``fvt_tpu/ops/winograd.py``.  A 3x3 stride-1 'same'
convolution computed per 2x2 output tile as ``Y = A^T [(G g G^T) *
(B^T d B)] A``: 16 transform-domain products per tile, input channel and
output channel where the direct convolution takes 36.  The transform
matrices hold only 0, +-1 (B, A) and +-1/2 (G), so the transforms are
exact in float32 and the result differs from the direct convolution only
in the order of the sums.  Layouts follow the JAX package: activations
NHWC, kernel HWIO ``(3, 3, C, Co)``, output ``(N, H, W, Co)``; odd H or W
are padded to whole tiles and cropped.

In float32 the computation runs in three stages, which are the three
launches of the CUDA kernel: :func:`input_transform` writes ``V = B^T d
B`` as ``(16, P, C)`` (P the 2x2 tiles of all frames, in (frame, tile
row, tile column) order), one batched product ``M[p] = V[p] @ U[p]`` over
the 16 transform-domain positions ``p = 4a + b`` gives ``(16, P, Co)``,
and :func:`output_transform` applies ``A^T M A`` and crops.

:func:`conv3x3_winograd_ref` is the plain version (the port of the
XLA-ops ``conv3x3_winograd``).  :func:`conv3x3_winograd` runs it for a
float32 tensor on the CPU; for a float32 CUDA tensor it launches the three
kernels of ``csrc/winograd_tf32x3.cu`` or raises: the product on the
tensor cores (``wgmma``) with split-TF32 operands, ``hi*hi + hi*lo +
lo*hi`` at float32 accuracy (:func:`conv3x3_winograd_tf32x3_ref` emulates
it), V and M in device memory.

bfloat16 (``--amp``) has its own route, with the JAX package's rounding
points (:func:`conv3x3_winograd_bf16_ref`, its plain version, which
:func:`conv3x3_winograd` runs for a bfloat16 tensor on the CPU): U from
the bfloat16 kernel in float32, rounded to bfloat16 once; V in bfloat16,
every add and subtract rounded (the transform is not exact there); the
products summed in float32; ``A^T M A`` in float32 and one rounding of y.
For a bfloat16 CUDA tensor :func:`conv3x3_winograd` launches the fused
kernel of ``csrc/winograd_bf16.cu`` or raises: one launch that stages x
by the copy engine (:func:`fused_plan`), forms V in registers and sums the
products on ``wgmma`` straight into the output phases, so that neither V
nor M lies in device memory.  :func:`launch_bf16`, the earlier design in
two launches (the input transform writes V, 8 channels a chunk,
:func:`v_chunks`; one ``wgmma`` product with the output transform in its
epilogue), stays to be timed: no model path calls it.  Neither type goes
to the other's kernel or to a library.

``conv3x3_winograd.launches`` counts its calls on the card (one for the
three launches of a float32 call, one for the bfloat16 launch),
``conv3x3_winograd.launches_fp32`` and
``conv3x3_winograd.launches_bf16`` those of each type.
:func:`conv3x3_winograd_simt`, the earlier float32 kernel on the CUDA
cores (``csrc/winograd.cu``, V and M kept on chip), stays for
measurements: no model path calls it.  Eval only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fvt_tpu_torch.kernels import build
from fvt_tpu_torch.ops.conv import column_tile, refuse_grad, split_tf32


def transform_weights(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, C, Co) -> transform-domain (4, 4, C, Co): U = G g G^T
    with G = [[1, 0, 0], [1/2, 1/2, 1/2], [1/2, -1/2, 1/2], [0, 0, 1]]
    applied over each of the two tap axes."""
    def g_rows(w):  # contract the leading 3-tap axis with G -> 4
        return torch.stack([w[0], 0.5 * (w[0] + w[1] + w[2]),
                            0.5 * (w[0] - w[1] + w[2]), w[2]])

    u = g_rows(kernel.float())                     # (4, 3, C, Co)
    u = g_rows(u.transpose(0, 1))                  # (4, 4, C, Co), (col, row)
    return u.transpose(0, 1).contiguous()          # back to (row, col)


def _bt(x0, x1, x2, x3):
    """B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]] along one tap
    axis, given the four tap slices."""
    return x0 - x2, x1 + x2, x2 - x1, x1 - x3


def _at(m0, m1, m2, m3):
    """A^T = [[1,1,1,0],[0,1,-1,-1]] along one tap axis."""
    return m0 + m1 + m2, m1 - m2 - m3


def input_transform(x: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C) -> V = B^T d B, (16, P, C) with P = N * ceil(H/2) *
    ceil(W/2): ``V[4a + b, p]`` for the 4x4 patch d of tile p, x zero
    outside the image; over the rows (a) first, then the columns (b)."""
    n, h, w, c = x.shape
    th, tw = -(-h // 2), -(-w // 2)
    # 'same' pad, then right/bottom pad so that the extent is 2*tiles + 2
    xp = F.pad(x, (0, 0, 1, 1 + 2 * tw - w, 1, 1 + 2 * th - h))
    # d[a][b](ty, tx) = xp[:, 2*ty + a, 2*tx + b, :]
    d = [[xp[:, a:a + 2 * th - 1:2, b:b + 2 * tw - 1:2, :]
          for b in range(4)] for a in range(4)]
    rows = [_bt(d[0][b], d[1][b], d[2][b], d[3][b]) for b in range(4)]
    v = [_bt(rows[0][a], rows[1][a], rows[2][a], rows[3][a])
         for a in range(4)]
    return torch.stack([v[a][b] for a in range(4) for b in range(4)]
                       ).reshape(16, n * th * tw, c)


def output_transform(m: torch.Tensor, n: int, h: int, w: int
                     ) -> torch.Tensor:
    """M (16, P, Co) -> Y = A^T M A, cropped to (N, H, W, Co); over the
    rows (a) first, then the columns."""
    th, tw = -(-h // 2), -(-w // 2)
    co = m.shape[2]
    ya = [_at(m[b], m[4 + b], m[8 + b], m[12 + b]) for b in range(4)]
    out = [_at(ya[0][i], ya[1][i], ya[2][i], ya[3][i]) for i in range(2)]
    y = torch.stack([torch.stack(out[0]), torch.stack(out[1])])
    y = y.reshape(2, 2, n, th, tw, co).permute(2, 3, 0, 4, 1, 5)
    return y.reshape(n, 2 * th, 2 * tw, co)[:, :h, :w, :].contiguous()


def conv3x3_winograd_ref(x: torch.Tensor, kernel: torch.Tensor,
                         u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version.  ``u`` is ``transform_weights(kernel)`` if
    the caller has it already."""
    n, h, w, c = x.shape
    co = kernel.shape[3]
    if u is None:
        u = transform_weights(kernel)
    m = torch.bmm(input_transform(x), u.reshape(16, c, co))
    return output_transform(m, n, h, w)


def conv3x3_winograd_tf32x3_ref(x: torch.Tensor, kernel: torch.Tensor,
                                u: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """What the split-TF32 kernel computes, emulated on float32 tensors:
    V and U split by :func:`~fvt_tpu_torch.ops.conv.split_tf32`, the
    product ``vh @ ul + vl @ uh + vh @ uh`` (each product of two TF32
    values exact in float32, the sums in float32), ``vl @ ul`` dropped."""
    n, h, w, c = x.shape
    co = kernel.shape[3]
    if u is None:
        u = transform_weights(kernel)
    vh, vl = split_tf32(input_transform(x))
    uh, ul = split_tf32(u.reshape(16, c, co).contiguous())
    m = (torch.bmm(vh, ul) + torch.bmm(vl, uh)) + torch.bmm(vh, uh)
    return output_transform(m, n, h, w)


def transform_weights_bf16(kernel: torch.Tensor) -> torch.Tensor:
    """U of the bfloat16 route, (16, C, Co) bfloat16: ``G g G^T`` in
    float32 from the HWIO kernel in bfloat16 (``kernel`` is rounded to
    bfloat16 first if it is not), rounded to bfloat16 once, as
    ``fvt_tpu``'s ``transform_weights(kernel.astype(bf16)).astype(bf16)``."""
    c, co = kernel.shape[2:]
    u = transform_weights(kernel.to(torch.bfloat16))
    return u.to(torch.bfloat16).reshape(16, c, co)


def conv3x3_winograd_bf16_ref(x: torch.Tensor, kernel: torch.Tensor,
                              u: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version of the bfloat16 route.  x (N, H, W, C) and the HWIO
    kernel bfloat16; ``u`` is ``transform_weights_bf16(kernel)``, (16, C,
    Co) or (4, 4, C, Co) bfloat16, if the caller has it.  The rounding
    points of ``fvt_tpu``'s ``conv3x3_winograd`` and ``_winograd_kernel``
    on bfloat16 arrays:

    1. U is ``G g G^T`` in float32 from the bfloat16 kernel, rounded to
       bfloat16 once;
    2. V = ``B^T d B`` is computed in bfloat16 (:func:`input_transform` on
       the bfloat16 x), over the rows first and then the columns, each add
       and subtract rounded to bfloat16;
    3. the products are bfloat16 x bfloat16, exact, summed in float32: V
       and U go to ``bmm`` as float32 (a bfloat16 ``bmm`` would round M);
    4. M and ``A^T M A`` stay float32; y is rounded to bfloat16 once."""
    n, h, w, c = x.shape
    co = kernel.shape[3]
    if u is None:
        u = transform_weights_bf16(kernel)
    v = input_transform(x.to(torch.bfloat16))
    m = torch.bmm(v.float(), u.reshape(16, c, co).float())
    return output_transform(m, n, h, w).to(torch.bfloat16)


def pack_winograd_weights_tf32(u: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transformed weights U (16, C, Co) or (4, 4, C, Co), C and Co
    multiples of 4, as the split-TF32 kernel copies them into shared
    memory: ``pack_weights_tf32`` of ``ops.conv`` with its tap axis
    replaced by the position axis.  The ``(hi, lo)`` parts of
    :func:`split_tf32`, each ``(16, tiles, ceil(C/8), 2, bn/8, 8, 4)``
    with ``bn = column_tile(Co)`` and ``part[p, t, s, h, n8, n, k] =
    split(u[p, 8*s + 4*h + k, bn*t + 8*n8 + n])``, zeros where the input
    channel is beyond C or the output channel beyond Co: per (position,
    column tile, 8-channel slice) the K-major core matrices (8 output
    channels x 4 inputs) ``wgmma`` reads.  A module derives them once and
    keeps them; :func:`conv3x3_winograd` derives them per call otherwise."""
    c, co = u.shape[-2:]
    bn = column_tile(co)
    tiles, slices = -(-co // bn), -(-c // 8)
    w = F.pad(u.reshape(16, c, co).float(),
              (0, tiles * bn - co, 0, slices * 8 - c))
    w = w.reshape(16, slices, 2, 4, tiles, bn // 8, 8)
    return split_tf32(w.permute(0, 4, 1, 2, 5, 6, 3).contiguous())


# output channels a tile of the bfloat16 Winograd product takes
BF16_BN = 64


def pack_winograd_weights_bf16(u: torch.Tensor) -> torch.Tensor:
    """U (16, C, Co) or (4, 4, C, Co) bfloat16, C a multiple of 16, in the
    layout the bfloat16 kernel copies into shared memory, one bulk copy a
    (position, column tile, 16-channel slice): ``(16, tiles, C/16, 2, 8,
    8, 8)`` with ``tiles = ceil(Co / 64)`` and ``packed[p, t, s, h, n8, k,
    n] = u[p, 16*s + 8*h + k, 64*t + 8*n8 + n]``, zeros where the output
    channel is beyond Co: the N-major 8x8 blocks ``wgmma`` reads (as
    ``ops.conv.pack_weights`` with one tap).  A module derives it once and
    keeps it; :func:`conv3x3_winograd` derives it per call otherwise."""
    c, co = u.shape[-2:]
    if c % 16:
        raise ValueError(f'C {c}: the bfloat16 Winograd kernel takes C in '
                         f'multiples of 16')
    tiles = -(-co // BF16_BN)
    w = F.pad(u.reshape(16, c, co).to(torch.bfloat16),
              (0, tiles * BF16_BN - co))
    w = w.reshape(16, c // 16, 2, 8, tiles, BF16_BN // 8, 8)
    return w.permute(0, 4, 1, 2, 5, 3, 6).contiguous()


# the stages of the CUDA entries, a bit each; the bfloat16 product has the
# output transform in its epilogue (BF16_STAGES: both of its launches)
INPUT_TRANSFORM, PRODUCT, OUTPUT_TRANSFORM = 1, 2, 4
ALL_STAGES = INPUT_TRANSFORM | PRODUCT | OUTPUT_TRANSFORM
BF16_STAGES = INPUT_TRANSFORM | PRODUCT


def check_widths(name: str, dtype: torch.dtype, c: int, co: int) -> None:
    """Raises for widths the CUDA kernel of ``dtype`` does not take:
    float32 C and Co multiples of 4, bfloat16 C a multiple of 16 (one k16
    step of ``wgmma``) and Co of 8."""
    if dtype == torch.bfloat16 and (c % 16 or co % 8):
        raise ValueError(f'C {c}, Co {co}: {name} takes C in multiples of 16 '
                         f'and Co in multiples of 8 on bfloat16 tensors')
    if dtype != torch.bfloat16 and (c % 4 or co % 4):
        raise ValueError(f'C {c}, Co {co}: {name} takes multiples of 4')


def _check_call(name: str, x: torch.Tensor, kernel: torch.Tensor,
                dtypes: tuple = (torch.float32, torch.bfloat16)) -> None:
    refuse_grad(name, x, kernel)
    if x.dtype not in dtypes or kernel.dtype != x.dtype:
        raise ValueError(f'x is {x.dtype} and kernel {kernel.dtype}: {name} '
                         f'takes both in one of {dtypes}')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no kernel for device {x.device}')
    if x.device.type == 'cuda':
        check_widths(name, x.dtype, x.shape[3], kernel.shape[3])


def workspace(x: torch.Tensor, co: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """V (16, P, C) and M (16, P, Co), float32 on x's device, for
    :func:`launch_tf32x3`."""
    n, h, w, c = x.shape
    p = n * -(-h // 2) * -(-w // 2)
    return (torch.empty((16, p, c), device=x.device, dtype=torch.float32),
            torch.empty((16, p, co), device=x.device, dtype=torch.float32))


def launch_tf32x3(x: torch.Tensor, packed: tuple, v: torch.Tensor,
                  m: torch.Tensor, out: torch.Tensor,
                  stages: int = ALL_STAGES) -> None:
    """Launches the ``stages`` of the split-TF32 Winograd kernel on the
    current stream: the input transform x -> v, the product v -> m, the
    output transform m -> out.  Checks every tensor and raises on a CUDA
    error; counts nothing (a measurement may launch one stage alone)."""
    n, h, w, c = x.shape
    co = out.shape[3]
    bn = column_tile(co)
    p = n * -(-h // 2) * -(-w // 2)
    shape = (16, -(-co // bn), -(-c // 8), 2, bn // 8, 8, 4)
    for name, t, want in (('x', x, (n, h, w, c)), ('v', v, (16, p, c)),
                          ('m', m, (16, p, co)), ('out', out, (n, h, w, co)),
                          ('packed hi', packed[0], shape),
                          ('packed lo', packed[1], shape)):
        build.check_tensor(name, t, want, x.device)
    err = build.library().fvt_winograd_tf32x3_forward(
        x.data_ptr(), packed[0].data_ptr(), packed[1].data_ptr(),
        v.data_ptr(), m.data_ptr(), out.data_ptr(), n, h, w, c, co, bn,
        stages, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'winograd split-TF32 kernel (N={n}, H={h}, W={w}, '
                     f'C={c}, Co={co}, stages={stages})')


def v_chunks(v: torch.Tensor) -> torch.Tensor:
    """V (16, P, C) as the bfloat16 kernel keeps it, 8 channels a chunk:
    ``(16, C/8, P8, 8)`` with P8 = P rounded up to a multiple of 8,
    ``out[pos, j, p, k] = v[pos, p, 8*j + k]`` and zeros in rows P ..
    P8-1, so that the product's copy of a chunk's rows is one contiguous
    piece, read in 128-byte rows of 8 of V's."""
    _, p, c = v.shape
    v = F.pad(v, (0, 0, 0, -p % 8))
    return v.reshape(16, -1, c // 8, 8).transpose(1, 2).contiguous()


def workspace_bf16(x: torch.Tensor) -> torch.Tensor:
    """V, bfloat16 on x's device, in the two-launch design's layout
    (:func:`v_chunks`: (16, C/8, P8, 8)), for :func:`launch_bf16`: that
    design's only workspace (the fused kernel takes none)."""
    n, h, w, c = x.shape
    p = n * -(-h // 2) * -(-w // 2)
    return torch.empty((16, c // 8, p + -p % 8, 8), device=x.device,
                       dtype=torch.bfloat16)


def launch_bf16(x: torch.Tensor, packed: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, stages: int = BF16_STAGES) -> None:
    """Launches the ``stages`` of the two-launch bfloat16 Winograd design
    on the current stream: the input transform x -> v
    (``INPUT_TRANSFORM``; v in :func:`v_chunks`' layout), the product v ->
    out with the output transform in its epilogue (``PRODUCT``).  Timed
    beside the fused kernel; no model path calls it.  Checks every tensor
    and raises on a CUDA error; counts nothing (a measurement may launch
    one stage alone)."""
    n, h, w, c = x.shape
    co = out.shape[3]
    p = n * -(-h // 2) * -(-w // 2)
    shape = (16, -(-co // BF16_BN), c // 16, 2, BF16_BN // 8, 8, 8)
    for name, t, want in (('x', x, (n, h, w, c)),
                          ('v', v, (16, c // 8, p + -p % 8, 8)),
                          ('out', out, (n, h, w, co)),
                          ('packed', packed, shape)):
        build.check_tensor(name, t, want, x.device, torch.bfloat16)
    err = build.library().fvt_winograd_bf16_forward(
        x.data_ptr(), packed.data_ptr(), v.data_ptr(), out.data_ptr(), n, h,
        w, c, co, stages, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'winograd bfloat16 kernel (N={n}, H={h}, W={w}, '
                     f'C={c}, Co={co}, stages={stages})')


# the fused kernel's row tile (tiles a block stages x for), the positions
# a copy-engine load brings, and the most loads a pixel and chunk
FUSED_ROWS, FUSED_LOAD, FUSED_MAX_LOADS = 128, 128, 4


def fused_plan(n: int, h: int, w: int) -> dict:
    """The fused kernel's staging plan for x (N, H, W, C), as
    ``fused_plan`` of ``csrc/winograd_bf16.cu`` computes it: ``th``,
    ``tw`` the tiles a frame, ``P`` the tiles, ``ext`` the positions a
    frame of the extended grid ((th+1) x (tw+1): position (f, ey, ex)
    holds the 2x2 pixels (2ey-1 + {0, 1}, 2ex-1 + {0, 1}), so that tile
    (f, ty, tx) reads its tap (r, c) at position (f, ty + r//2, tx +
    c//2), pixel (r%2, c%2)), ``E`` the positions in all, and ``loads``
    and ``e_pad`` = ``loads * FUSED_LOAD``: the positions a row tile of
    FUSED_ROWS tiles stages a pixel and 8-channel chunk, a bound of its
    span e(p_last) + tw + 3 - e(p0) from the tile rows and frames its 127
    steps cross.  Raises where that needs more than FUSED_MAX_LOADS loads:
    a row tile that crosses a frame of W above about 380 (no ArcFace
    shape; 1x1 frames take all four)."""
    th, tw = -(-h // 2), -(-w // 2)
    plan = dict(th=th, tw=tw, P=n * th * tw, ext=(th + 1) * (tw + 1),
                E=n * (th + 1) * (tw + 1))
    steps = FUSED_ROWS - 1
    rows = min(-(-steps // tw), n * th - 1)        # tile rows crossed
    frames = min(-(-steps // (th * tw)), n - 1)   # frames crossed
    span = steps + rows + frames * (tw + 1) + tw + 3
    span = min(span, fused_position(plan, plan['P'] - 1) + tw + 3)
    loads = -(-span // FUSED_LOAD)
    if loads > FUSED_MAX_LOADS:
        raise ValueError(f'N={n}, H={h}, W={w}: a row tile stages {span} '
                         f'positions, more than {FUSED_MAX_LOADS} loads')
    plan.update(loads=loads, e_pad=loads * FUSED_LOAD)
    return plan


def fused_position(plan: dict, p: int) -> int:
    """The extended grid's position of tile p (:func:`fused_plan`)."""
    f, r = divmod(p, plan['th'] * plan['tw'])
    ty, tx = divmod(r, plan['tw'])
    return f * plan['ext'] + ty * (plan['tw'] + 1) + tx


def launch_bf16_fused(x: torch.Tensor, packed: torch.Tensor,
                      out: torch.Tensor) -> None:
    """Launches the fused bfloat16 Winograd kernel on the current stream:
    x -> out in one launch, V formed in registers from x staged by the
    copy engine (:func:`fused_plan`), no workspace.  ``packed`` is
    :func:`pack_winograd_weights_bf16`'s layout.  Checks every tensor and
    raises on a CUDA error; counts nothing."""
    n, h, w, c = x.shape
    co = out.shape[3]
    fused_plan(n, h, w)  # raises for a frame the staging does not take
    shape = (16, -(-co // BF16_BN), c // 16, 2, BF16_BN // 8, 8, 8)
    for name, t, want in (('x', x, (n, h, w, c)),
                          ('out', out, (n, h, w, co)),
                          ('packed', packed, shape)):
        build.check_tensor(name, t, want, x.device, torch.bfloat16)
    err = build.library().fvt_winograd_bf16_fused_forward(
        x.data_ptr(), packed.data_ptr(), out.data_ptr(), n, h, w, c, co,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'fused winograd bfloat16 kernel (N={n}, H={h}, W={w}, '
                     f'C={c}, Co={co})')


def conv3x3_winograd(x: torch.Tensor, kernel: torch.Tensor,
                     u: Optional[torch.Tensor] = None,
                     packed=None) -> torch.Tensor:
    """x (N, H, W, C) and kernel HWIO (3, 3, C, Co), both float32 or both
    bfloat16.  Returns (N, H, W, Co) in the same type.  ``u``: the
    transformed weights, (4, 4, C, Co) or (16, C, Co) (float32:
    ``transform_weights(kernel)``; bfloat16: ``transform_weights_bf16(
    kernel)``), and ``packed``: ``pack_winograd_weights_tf32(u)`` (a pair)
    or ``pack_winograd_weights_bf16(u)``, when the caller keeps them (they
    are derived outside the kernel, once per weight); derived here
    otherwise.  On the card a float32 call's workspace (V and M, 16 * P *
    (C + Co) floats, :func:`workspace`) comes from the caching allocator;
    a bfloat16 call is one launch of the fused kernel and takes none."""
    _check_call('conv3x3_winograd', x, kernel)
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == 'cpu':
        return (conv3x3_winograd_bf16_ref if bf16
                else conv3x3_winograd_ref)(x, kernel, u)
    n, h, w, c = x.shape
    co = kernel.shape[3]
    if packed is None:
        if u is None:
            build.check_tensor('kernel', kernel, (3, 3, c, co), x.device,
                               x.dtype)
            u = (transform_weights_bf16 if bf16 else transform_weights)(
                kernel)
        packed = (pack_winograd_weights_bf16 if bf16
                  else pack_winograd_weights_tf32)(u)
    out = torch.empty((n, h, w, co), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    if bf16:
        launch_bf16_fused(x, packed, out)
        conv3x3_winograd.launches_bf16 += 1
    else:
        v, m = workspace(x, co)
        launch_tf32x3(x, packed, v, m, out)
        conv3x3_winograd.launches_fp32 += 1
    conv3x3_winograd.launches += 1
    return out


conv3x3_winograd.launches = 0
conv3x3_winograd.launches_fp32 = 0
conv3x3_winograd.launches_bf16 = 0


def conv3x3_winograd_simt(x: torch.Tensor, kernel: torch.Tensor,
                          u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The earlier Winograd kernel, on the CUDA cores
    (``csrc/winograd.cu``), kept to be timed beside
    :func:`conv3x3_winograd`'s: no model path calls it.  x (N, H, W, C)
    and kernel HWIO (3, 3, C, Co) float32, C and Co multiples of 4; ``u``
    as for :func:`conv3x3_winograd`.  The plain version on the CPU;
    ``conv3x3_winograd_simt.launches`` counts its launches."""
    _check_call('conv3x3_winograd_simt', x, kernel, (torch.float32,))
    if x.device.type == 'cpu':
        return conv3x3_winograd_ref(x, kernel, u)
    n, h, w, c = x.shape
    co = kernel.shape[3]
    if u is None:
        build.check_tensor('kernel', kernel, (3, 3, c, co), x.device)
        u = transform_weights(kernel)
    u = u.reshape(16, c, co)
    build.check_tensor('x', x, (n, h, w, c), x.device)
    build.check_tensor('u', u, (16, c, co), x.device)
    out = torch.empty((n, h, w, co), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = build.library().fvt_winograd_forward(
        x.data_ptr(), u.data_ptr(), out.data_ptr(), n, h, w, c, co,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'winograd SIMT kernel (N={n}, H={h}, W={w}, C={c}, '
                     f'Co={co})')
    conv3x3_winograd_simt.launches += 1
    return out


conv3x3_winograd_simt.launches = 0
