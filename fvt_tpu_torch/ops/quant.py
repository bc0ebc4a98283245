"""int8 serving of the frozen ArcFace (``--serve_quant int8 | int8_static``):
the quantisation arithmetic, the s8 3x3 convolution, its CUDA kernels and
plain versions.  Counterpart of ``fvt_tpu/ops/quant.py``.

The scheme is ``fvt_tpu``'s.  Weights: symmetric int8 per output channel,
``scale = max(max|w|, 1e-12) / 127`` over (kh, kw, Cin).  Activations:
symmetric int8 per tensor, the scale from the call's own ``max|x|``
(dynamic, ``int8``) or from a calibrated amax (static, ``int8_static``).
``q = clip(round(x / scale), -127, 127)``, rounded half to even, so
``q(0) == 0`` and zero padding commutes with the quantisation.  The conv
sums s8 x s8 products in int32; the output is ``float(acc) * (x_scale *
w_scale[co])``, stored in ``out_dtype``.  A bfloat16 input (``--amp``) is
widened to float32, exactly, before it is quantised.

``fvt_tpu`` runs that conv as one XLA convolution on the TPU's int8 path,
not as a Pallas kernel, and XLA fuses the input's quantisation into the
epilogue of the op that produces the input.  PyTorch has no int8
convolution on CUDA, so the port brings kernels of its own.
:func:`quantize_int8` is the quantisation pass (``csrc/
quantize_int8_fused.cu``): the producer of a quantised conv's input, the
block's eval bn1 or its PReLU, is applied as the pass loads its input (a
``prologue``, :func:`prologue_ref`), so the producer runs no pass of its
own; dynamic, a persistent amax launch that leaves one max a block and a
quantise launch that reduces those first; static, the quantise launch
alone; the division by a reciprocal, with an exact division where that
could round otherwise (:func:`reciprocal_rint`).  :func:`conv3x3_s8` is the
convolution on 8-bit ``wgmma`` with TMA-staged operands and a persistent
grid, the scaling in its epilogue, one launch a call
(``csrc/conv3x3_s8_wgmma.cu``).  Its route and ring are :func:`s8_plan`'s:
stride 1 on the bf16 conv kernel's padded line (each tile's patch staged
once a 32-channel slice, the nine taps as descriptor offsets), stride 2,
and stride 1 on frames too wide for that staging, on a per-tap walk of the
im2col map (one load a tap, no pad rows).  Its weights are
:func:`pack_weights_s8` of ``wq``, which a module derives once and keeps;
the call packs them otherwise.  The earlier designs, on no path and kept to
be timed, are in ``csrc/conv3x3_int8.cu``: the quantisation pass
:func:`quantize_int8_atomic` (a memset, an amax launch with an atomic a
block and a quantise launch, on the producer's output) and the conv
:func:`conv3x3_s8_mma` on ``mma.sync`` (:func:`conv_plan`).  Each wrapper
routes a CPU tensor to its plain version and a CUDA tensor to its kernel,
or raises; each counts its launches (``quantize_int8.launches`` (the
quantising launches) and ``.launches_amax``, the same two on
``quantize_int8_atomic``, ``conv3x3_s8.launches``,
``conv3x3_s8_mma.launches``).  Inside a sharded serving call
(``parallel/collectives.py``, ``parallel/serving.py``) a dynamic scale
spans the call, as ``fvt_tpu``'s one GSPMD program's does: this rank's
amax (the amax launches alone on the card), the max over the ranks
(``all_reduce_max``), then the quantise launch with that scale, the
prologue in both.  The kernels equal the plain versions bit for bit: the
prologue's steps round where PyTorch's ops on x's type round, the scale is
an IEEE division and the quantisation equals one, the sums are exact, the
accumulator rounded to float32 once (the plain version sums in float64,
exact below 2^53).  :func:`conv3x3_int8` is the composition ``fvt_tpu``
calls by that name, :func:`conv3x3_int8_ref` its plain version,
:func:`conv3x3_int8_9mm` the nine-matmul form ``fvt_tpu`` keeps for the
record.  Activations are NHWC, kernels HWIO, as in ``fvt_tpu``; the
quantised weights are ``(Co, 9, C)``, K-major, the only layout 8-bit
``wgmma`` (and the s8 ``mma``) takes B in.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fvt_tpu_torch.kernels import build
from fvt_tpu_torch.ops.conv import refuse_grad
from fvt_tpu_torch.parallel import collectives

# the convs with at least this many input channels are quantised; stage 1
# (64 channels) stays on the float path, as in fvt_tpu (arcface.py:58)
MIN_CIN = 128
# the mma.sync design's tiles (csrc/conv3x3_int8.cu): pixels and output
# channels a block, channels a K step
TILE_M, TILE_N, TILE_K = 128, 128, 64
STAGES = 3
SMEM_PITCH = TILE_K + 16
# the wgmma kernel's (csrc/conv3x3_s8_wgmma.cu, wgmma_common.cuh): rows and
# output channels a tile, channels a slice (one k32 step), coordinates a TMA
# load, consumer warpgroups, the shared memory a block may take
S8_BM, S8_BN, S8_KC, S8_LOAD, S8_WG = 256, 128, 32, 128, 4
MAX_SMEM = 227 * 1024
S8_OUT_BYTES = S8_WG * 4 * 16 * (2 * S8_BN + 16)  # the staged output rows
OUT_DTYPES = (torch.float32, torch.bfloat16)


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127`` in float32.  The divisor is a tensor: a
    Python scalar divisor would be a multiplication by its reciprocal on
    CUDA."""
    amax = amax.float()
    return torch.clamp_min(amax, 1e-12) / torch.full_like(amax, 127.0)


def quantize_with(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8, x widened to float32
    first; ``round`` is half to even, as ``jnp.round``."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def quantize_symmetric(x: torch.Tensor, dims=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale), ``fvt_tpu``'s ``quantize_symmetric``:
    ``dims`` are the reduced dimensions (None: per tensor); the scale keeps
    them as size 1."""
    a = x.float().abs()
    if dims is None:
        amax = a.amax().reshape((1,) * x.dim())
    else:
        amax = a.amax(dim=dims, keepdim=True)
    scale = act_scale(amax)
    return quantize_with(x, scale), scale


def quantize_weights(kernel: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float HWIO kernel (3, 3, C, Co) quantised per output channel, in
    the kernel's layout: ``wq`` (Co, 9, C) int8 with ``wq[co, 3*ky + kx,
    c] = q[ky, kx, c, co]`` and ``wscale`` (Co,) float32, the values of
    ``quantize_symmetric(kernel, dims=(0, 1, 2))``."""
    q, scale = quantize_symmetric(kernel, dims=(0, 1, 2))
    c, co = kernel.shape[2:]
    wq = q.reshape(9, c, co).permute(2, 0, 1).contiguous()
    return wq, scale.reshape(co).contiguous()


def out_size(h: int, stride: int) -> int:
    """Output rows of a 3x3 conv with padding 1."""
    return (h - 1) // stride + 1


def check_shape(c: int, co: int, stride: int) -> None:
    """Raises for what the s8 kernel does not take."""
    if c % 16 or co % 8:
        raise ValueError(f'C {c}, Co {co}: the s8 conv kernel takes C in '
                         f'multiples of 16 and Co in multiples of 8')
    if stride not in (1, 2):
        raise ValueError(f'stride {stride}: the s8 conv kernel takes 1 or 2')


def conv_plan(n: int, h: int, w: int, c: int, co: int, stride: int) -> dict:
    """The ``mma.sync`` design's launch (:func:`conv3x3_s8_mma`, on no
    path) for these sizes, as its C entry computes it:
    the output rows and columns, the M = N*Ho*Wo pixels of the implicit
    GEMM, the grid of TILE_M x TILE_N blocks, the K steps (nine taps by
    TILE_K channels) and the dynamic shared memory of the ring."""
    check_shape(c, co, stride)
    ho, wo = out_size(h, stride), out_size(w, stride)
    m = n * ho * wo
    return {'ho': ho, 'wo': wo, 'm': m,
            'grid': (-(-m // TILE_M), -(-co // TILE_N)),
            'k_steps': 9 * -(-c // TILE_K),
            'smem_bytes': STAGES * (TILE_M + TILE_N) * SMEM_PITCH}


def s8_slot_bytes(walk: bool, p: int) -> int:
    """A ring slot of the wgmma kernel: the staged A (padded line: one
    patch of ``p`` coordinates; walk: three taps of ``p`` rows), 32 bytes a
    coordinate, then its taps' packed weights (nine or three, ``S8_KC *
    S8_BN`` bytes each)."""
    return (3 if walk else 1) * p * S8_KC + (3 if walk else 9) * S8_KC * S8_BN


def s8_smem_bytes(walk: bool, p: int, slots: int) -> int:
    """The wgmma kernel's dynamic shared memory: the ring's barriers, up to
    1023 bytes to align the ring, its slots and the staged output rows."""
    return 128 + 1024 + slots * s8_slot_bytes(walk, p) + S8_OUT_BYTES


def s8_plan(n: int, h: int, w: int, c: int, co: int, stride: int) -> dict:
    """The wgmma kernel's launch for these sizes, as its C entry computes
    it (``csrc/conv3x3_s8_wgmma.cu`` s8_plan): ``route`` ``'padded'``
    (stride 1 while the padded line's staging, ``p = S8_BM + 2*(W+1) + 2``
    coordinates rounded up to ``S8_LOAD``, fits a ring of 3 or 2 slots and
    the producer's 32 lanes, i.e. W <= 510) or ``'walk'`` (stride 2, and
    wider frames: ``p = S8_BM`` pixels a tap, a ring of 4); ``p``, the
    ``loads`` a slice (and tap) of a slot, the ``slots``, the ring
    ``steps`` a tile (slices, times the three tap rows on the walk), the
    taps a step, ``q`` (the padded coordinates or pixels the walk runs
    over), the ``rows`` the tiles cover (from the first pixel, W + 2 into
    the padded line), the ``tiles`` (row tiles times column tiles) and the
    ``smem_bytes``."""
    check_shape(c, co, stride)
    ho, wo = out_size(h, stride), out_size(w, stride)
    m = n * ho * wo
    walk, slots = True, 4
    p = -(-(S8_BM + 2 * (w + 1) + 2) // S8_LOAD) * S8_LOAD
    if stride == 1 and p // S8_LOAD <= 32:  # a producer lane a load
        for depth in (3, 2):
            if s8_smem_bytes(False, p, depth) <= MAX_SMEM:
                walk, slots = False, depth
                break
    if walk:
        p = S8_BM
    q = m if walk else n * (h + 1) * (w + 1)
    rows = m if walk else q - (w + 2)
    slices = -(-c // S8_KC)
    return {'route': 'walk' if walk else 'padded', 'ho': ho, 'wo': wo,
            'm': m, 'p': p, 'loads': p // S8_LOAD, 'slots': slots,
            'steps': slices * (3 if walk else 1), 'slices': slices,
            'taps_a_step': 3 if walk else 9, 'q': q, 'rows': rows,
            'tiles': -(-rows // S8_BM) * -(-co // S8_BN),
            'smem_bytes': s8_smem_bytes(walk, p, slots)}


def pack_weights_s8(wq: torch.Tensor) -> torch.Tensor:
    """``wq`` (Co, 9, C) int8 in the layout the wgmma kernel copies into
    shared memory: per column tile of ``S8_BN`` output channels and
    32-channel slice, the nine taps' two 16-channel chunks as ``S8_BN``
    K-major rows of 16 bytes.  Returns ``(tiles, ceil(C/32), 9, 2, S8_BN,
    16)`` int8 with ``packed[t, s, tap, h, n, k] = wq[S8_BN*t + n, tap,
    32*s + 16*h + k]`` and zeros where the channel is beyond C or the output
    channel beyond Co.  ``Conv3x3.int8_weights`` keeps it beside ``wq``;
    :func:`conv3x3_s8` packs per call otherwise."""
    co, taps, c = wq.shape
    tiles, slices = -(-co // S8_BN), -(-c // S8_KC)
    w = F.pad(wq, (0, slices * S8_KC - c, 0, 0, 0, tiles * S8_BN - co))
    w = w.reshape(tiles, S8_BN, taps, slices, 2, 16)
    return w.permute(0, 3, 2, 4, 1, 5).contiguous()


def tap_rows(xq: torch.Tensor, stride: int) -> torch.Tensor:
    """The kernel's A operand made explicit: (M, 9, C) with row m = (n, ho,
    wo) and tap t = 3*ky + kx holding ``xq[n, ho*stride + ky - 1, wo*stride
    + kx - 1, :]``, zeros where that falls in the padding: the addresses
    the kernel's copies compute.  ``tap_rows(xq).reshape(M, 9*C) @
    wq.reshape(Co, 9*C).T`` is the conv's int32 sum (the im2col that
    ``torch._int_mm`` is timed on as a yardstick)."""
    n, h, w, c = xq.shape
    ho, wo = out_size(h, stride), out_size(w, stride)
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, ky:ky + (ho - 1) * stride + 1:stride,
               kx:kx + (wo - 1) * stride + 1:stride, :]
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps, dim=3).reshape(n * ho * wo, 9, c)


def tap_sum(xq: torch.Tensor, wq: torch.Tensor, stride: int
            ) -> torch.Tensor:
    """The conv's sum of s8 x s8 products as nine shifted ``(M, C) @ (C,
    Co)`` products in float64, summed in tap order: every partial sum is
    an integer below 9*C*127^2 < 2^53, so exact in any order (and on any
    device, where a float64 convolution might take an inexact FFT
    algorithm).  xq (N, H, W, C) int8, wq (Co, 9, C) int8; returns (M,
    Co) float64, M = N*Ho*Wo."""
    n, h, w, c = xq.shape
    ho, wo = out_size(h, stride), out_size(w, stride)
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(n * ho * wo, wq.shape[0], dtype=torch.float64,
                      device=xq.device)
    for t in range(9):
        ky, kx = divmod(t, 3)
        xs = xp[:, ky:ky + (ho - 1) * stride + 1:stride,
                kx:kx + (wo - 1) * stride + 1:stride, :]
        acc.addmm_(xs.reshape(-1, c).double(), wq[:, t].double().T)
    return acc


def dequantize(acc: torch.Tensor, x_scale: torch.Tensor,
               wscale: torch.Tensor, shape: tuple,
               out_dtype: torch.dtype) -> torch.Tensor:
    """``float32(acc) * (x_scale * wscale)`` in ``out_dtype``, (M, Co) ->
    ``shape``: the accumulator rounded to float32 once (it is an exact
    integer), the scales' product formed first."""
    scale = x_scale.reshape(()) * wscale.reshape(-1)
    return (acc.float() * scale).to(out_dtype).reshape(shape)


def conv3x3_s8_ref(xq: torch.Tensor, x_scale: torch.Tensor,
                   wq: torch.Tensor, wscale: torch.Tensor, stride: int,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the s8 conv on any device: :func:`tap_sum`, then
    :func:`dequantize`.  xq (N, H, W, C) int8, wq (Co, 9, C) int8;
    returns (N, Ho, Wo, Co)."""
    n, h, w, _ = xq.shape
    shape = (n, out_size(h, stride), out_size(w, stride), wq.shape[0])
    return dequantize(tap_sum(xq, wq, stride), x_scale, wscale, shape,
                      out_dtype)


def _check_x(name: str, x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'x is {x.dtype}: {name} takes float32 or bfloat16')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no kernel for device {x.device}')


# the fused pass (csrc/quantize_int8_fused.cu): the partials a dynamic call's
# words hold room for (kMaxParts), the most channels a prologue may have
# (kMaxC), the C entry's code of each prologue and its per-channel tensors
MAX_PARTS = 4096
MAX_C = 4096
PROLOGUES = {'bn1': (1, ('mean', 'inv', 'bias')), 'prelu': (2, ('alpha',))}
# t = v * RN(1/s) lies more than 2^-12 from every half-integer where
# |t - rint(t)| is below this (the kernel's kFast)
RECIPROCAL_MARGIN = 0.5 - 2.0 ** -12


def prologue_ref(x: torch.Tensor, prologue: Optional[tuple]) -> torch.Tensor:
    """The producer of a quantised conv's input applied to x (..., C), in
    x's type, each step rounded to it (``fvt_tpu``'s arithmetic,
    ``layers.py:180-182`` and ``:214``): None, x itself; ``('bn1', mean,
    inv, bias)``, the eval BatchNorm ``((x - mean) * inv) + bias``;
    ``('prelu', alpha)``, ``where(x >= 0, x, x * alpha)``.  The tensors are
    per channel, in x's type."""
    if prologue is None:
        return x
    kind, *params = prologue
    if kind not in PROLOGUES or len(params) != len(PROLOGUES[kind][1]):
        raise ValueError(f'prologue {kind!r} with {len(params)} tensors: '
                         f'None, (\'bn1\', mean, inv, bias) or (\'prelu\', '
                         f'alpha)')
    if kind == 'bn1':
        mean, inv, bias = params
        return (x - mean) * inv + bias
    alpha, = params
    return torch.where(x >= 0, x, x * alpha)


# 1.5 * 2^23: t + RINT_MAGIC - RINT_MAGIC is t rounded half to even for |t|
# < 2^22, and beyond +-127 past that (the kernel's kMagic)
RINT_MAGIC = 12582912.0


def reciprocal_rint(v: torch.Tensor, scale: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's ``rint(v / scale)`` emulated in float32 ops: ``t = v *
    RN(1 / scale)`` rounded by adding and subtracting ``RINT_MAGIC``,
    except where ``t`` lies within 2^-12 of a half-integer or is not
    finite, or ``RN(1 / scale)`` is not a normal number, where ``rint(v /
    scale)`` itself.  Equal to ``rint(v / scale)`` once both are clipped
    to +-127.  Returns (the rounded values, where the exact division was
    taken)."""
    v, scale = v.float(), scale.float()
    r = torch.ones_like(scale) / scale
    t = v * r
    rt = (t + RINT_MAGIC) - RINT_MAGIC
    tiny = torch.finfo(torch.float32).tiny
    normal = (r >= tiny) & (r <= torch.finfo(torch.float32).max)
    exact = ~((t - rt).abs() < RECIPROCAL_MARGIN) | ~normal
    return torch.where(exact, torch.round(v / scale), rt), exact


def quantize_int8_ref(x: torch.Tensor,
                      x_scale: Optional[torch.Tensor] = None,
                      prologue: Optional[tuple] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]:
    """Plain version of :func:`quantize_int8` on any device: the prologue
    (:func:`prologue_ref`), then the amax and the quantisation."""
    x = prologue_ref(x, prologue)
    amax = None
    if x_scale is None:
        amax = x.float().abs().amax().reshape(1)
        if collectives.current() is not None:  # the scale spans the call
            amax = collectives.all_reduce_max(amax)
        x_scale = act_scale(amax)
    return quantize_with(x, x_scale.reshape(())), x_scale, amax


def fused_args(x: torch.Tensor, prologue: Optional[tuple]) -> tuple:
    """Raises for what the fused pass does not take (an x that is not
    NHWC-contiguous or not of 16-value chunks, a prologue with C not a
    multiple of 16 or above ``MAX_C``, prologue tensors of another length,
    type or device); returns the C entry's C, prologue code and three
    pointers (None where unused)."""
    build.check_tensor('x', x, tuple(x.shape), x.device, x.dtype)
    if x.numel() % 16:
        raise ValueError(f'{x.numel()} values: the quantise kernel takes '
                         f'multiples of 16')
    if prologue is None:
        return 16, 0, None, None, None
    kind, *params = prologue
    if kind not in PROLOGUES:
        raise ValueError(f'prologue {kind!r}: bn1 or prelu')
    code, names = PROLOGUES[kind]
    c = x.shape[-1]
    if c % 16 or c > MAX_C:
        raise ValueError(f'C {c}: a prologue takes C in multiples of 16 up '
                         f'to {MAX_C}')
    if len(params) != len(names):
        raise ValueError(f'prologue {kind!r} takes {names}')
    for name, t in zip(names, params):
        build.check_tensor(f'{kind} {name}', t, (c,), x.device, x.dtype)
    ptrs = [t.data_ptr() for t in params]
    return (c, code, *ptrs, *[None] * (3 - len(ptrs)))


def quantize_int8(x: torch.Tensor, x_scale: Optional[torch.Tensor] = None,
                  prologue: Optional[tuple] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """x (NHWC-contiguous, float32 or bfloat16) -> (q int8 of x's shape,
    the scale (a float32 tensor of one value), the amax or None) of
    ``prologue_ref(x, prologue)``, as :func:`quantize_int8_ref`.  Dynamic
    (``x_scale`` None): the scale is ``act_scale(max|v|)`` and the amax is
    returned; static: ``x_scale`` (one float32 value on x's device) is the
    scale.  On the CPU the plain version; on the card the fused pass
    (``csrc/quantize_int8_fused.cu``), two launches dynamic (the amax
    launch and the quantising one), one static, or raises
    (:func:`fused_args`).  Dynamic inside a sharded call: the amax and the
    scale span every rank's rows (module docstring)."""
    _check_x('quantize_int8', x)
    if x.device.type == 'cpu':
        return quantize_int8_ref(x, x_scale, prologue)
    args = fused_args(x, prologue)
    if x_scale is not None and (x_scale.device != x.device
                                or x_scale.dtype != torch.float32
                                or x_scale.numel() != 1):
        raise ValueError('x_scale: one float32 value on x\'s device')
    n = x.numel()
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16 = int(x.dtype == torch.bfloat16)
    q = None
    words = None
    sharded = x_scale is None and collectives.current() is not None
    if x_scale is None:
        # the amax, the scale, then the partials (one a block of the amax
        # launch)
        words = torch.empty(2 + MAX_PARTS, dtype=torch.float32,
                            device=x.device)
    if not sharded:
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    err = lib.fvt_quantize_int8_fused(
        x.data_ptr(), bf16, n, *args,
        None if x_scale is None else x_scale.data_ptr(),
        None if words is None else words.data_ptr(),
        None if q is None else q.data_ptr(), stream)
    build.check(err, f'quantize_int8 kernel (n={n}, C={args[0]}, '
                     f'prologue {args[1]}, '
                     f'{"static" if x_scale is not None else "dynamic"})')
    if x_scale is None:
        quantize_int8.launches_amax += 1
    if sharded:
        # the max over the ranks, then the static launch with the call's
        # scale
        amax = collectives.all_reduce_max(words[:1])
        q, scale, _ = quantize_int8(x, act_scale(amax), prologue)
        return q, scale, amax
    quantize_int8.launches += 1
    if x_scale is None:
        return q, words[1:2], words[:1]
    return q, x_scale, None


quantize_int8.launches = 0
quantize_int8.launches_amax = 0


def quantize_int8_atomic(x: torch.Tensor,
                         x_scale: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Optional[torch.Tensor]]:
    """The earlier design of :func:`quantize_int8` without a prologue, on
    no path, kept to be timed beside it (``csrc/conv3x3_int8.cu``
    ``fvt_quantize_int8``: a memset of the amax word and an amax launch
    with one ``atomicMax`` a block, then the quantise launch; static, the
    quantise launch alone): x of any shape, the same result as
    ``quantize_int8(x, x_scale)``, its own launch counts."""
    _check_x('quantize_int8_atomic', x)
    if x.device.type == 'cpu':
        return quantize_int8_ref(x, x_scale)
    n = x.numel()
    if n % 16:
        raise ValueError(f'{n} values: the quantise kernel takes multiples '
                         f'of 16')
    build.check_tensor('x', x, tuple(x.shape), x.device, x.dtype)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build.library()
    bf16 = int(x.dtype == torch.bfloat16)
    if x_scale is None and collectives.current() is not None:
        # the amax launch alone (q null), the max over the ranks, then the
        # static route's launch with the call's scale
        amax = torch.empty(1, dtype=torch.float32, device=x.device)
        err = lib.fvt_quantize_int8(x.data_ptr(), bf16, n, amax.data_ptr(),
                                    None, None, None, stream)
        build.check(err, f'quantize_int8_atomic kernel (n={n}, amax)')
        quantize_int8_atomic.launches_amax += 1
        amax = collectives.all_reduce_max(amax)
        q, scale, _ = quantize_int8_atomic(x, act_scale(amax))
        return q, scale, amax
    if x_scale is None:
        # word 0: the amax's bits (atomicMax), word 1: the scale
        words = torch.empty(2, dtype=torch.float32, device=x.device)
        err = lib.fvt_quantize_int8(x.data_ptr(), bf16, n, words.data_ptr(),
                                    None, words[1:].data_ptr(),
                                    q.data_ptr(), stream)
        build.check(err, f'quantize_int8_atomic kernel (n={n}, dynamic)')
        quantize_int8_atomic.launches += 1
        quantize_int8_atomic.launches_amax += 1
        return q, words[1:], words[:1]
    if (x_scale.device != x.device or x_scale.dtype != torch.float32
            or x_scale.numel() != 1):
        raise ValueError('x_scale: one float32 value on x\'s device')
    err = lib.fvt_quantize_int8(x.data_ptr(), bf16, n, None,
                                x_scale.data_ptr(), None, q.data_ptr(),
                                stream)
    build.check(err, f'quantize_int8_atomic kernel (n={n}, static)')
    quantize_int8_atomic.launches += 1
    return q, x_scale, None


quantize_int8_atomic.launches = 0
quantize_int8_atomic.launches_amax = 0


def _check_s8(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor,
              wscale: torch.Tensor, stride: int, out_dtype: torch.dtype
              ) -> Tuple[int, int, int, int, int, torch.Tensor]:
    """Raises for what the s8 kernels do not take; returns N, H, W, C, Co
    and an empty y."""
    n, h, w, c = xq.shape
    co = wq.shape[0]
    check_shape(c, co, stride)
    build.check_tensor('xq', xq, (n, h, w, c), xq.device, torch.int8)
    build.check_tensor('wq', wq, (co, 9, c), xq.device, torch.int8)
    build.check_tensor('wscale', wscale, (co,), xq.device)
    if (x_scale.device != xq.device or x_scale.dtype != torch.float32
            or x_scale.numel() != 1):
        raise ValueError('x_scale: one float32 value on xq\'s device')
    y = torch.empty((n, out_size(h, stride), out_size(w, stride), co),
                    dtype=out_dtype, device=xq.device)
    return n, h, w, c, co, y


def _s8_route(name: str, xq: torch.Tensor, wq: torch.Tensor,
              out_dtype: torch.dtype) -> bool:
    """True where an s8 conv wrapper runs its plain version (a CPU tensor);
    raises for another type or device."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f'out_dtype {out_dtype}: float32 or bfloat16')
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f'{name} takes int8 xq and wq')
    if xq.device.type == 'cpu':
        return True
    if xq.device.type != 'cuda':
        raise ValueError(f'no kernel for device {xq.device}')
    return False


def conv3x3_s8(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor,
               wscale: torch.Tensor, stride: int = 1,
               out_dtype: torch.dtype = torch.bfloat16,
               packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The s8 conv: xq (N, H, W, C) int8, x_scale one float32 value, wq
    (Co, 9, C) int8, wscale (Co,) float32 -> (N, Ho, Wo, Co) in
    ``out_dtype`` (float32 or bfloat16).  On the CPU
    :func:`conv3x3_s8_ref`; on the card one launch of the wgmma kernel of
    ``csrc/conv3x3_s8_wgmma.cu`` (C a multiple of 16, Co of 8, stride 1
    or 2, any H and W) or raises.  ``packed``: :func:`pack_weights_s8` of
    ``wq``, kept by the caller; packed here otherwise."""
    if _s8_route('conv3x3_s8', xq, wq, out_dtype):
        return conv3x3_s8_ref(xq, x_scale, wq, wscale, stride, out_dtype)
    n, h, w, c, co, y = _check_s8(xq, x_scale, wq, wscale, stride,
                                  out_dtype)
    if packed is None:
        packed = pack_weights_s8(wq)
    build.check_tensor('packed', packed,
                       (-(-co // S8_BN), -(-c // S8_KC), 9, 2, S8_BN, 16),
                       xq.device, torch.int8)
    err = build.library().fvt_conv3x3_s8_forward(
        xq.data_ptr(), packed.data_ptr(), wscale.data_ptr(),
        x_scale.data_ptr(), y.data_ptr(), int(out_dtype == torch.bfloat16),
        n, h, w, c, co, stride,
        torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, f'conv3x3_s8 kernel (N={n}, H={h}, W={w}, C={c}, '
                     f'Co={co}, stride={stride})')
    conv3x3_s8.launches += 1
    return y


conv3x3_s8.launches = 0


def conv3x3_s8_mma(xq: torch.Tensor, x_scale: torch.Tensor,
                   wq: torch.Tensor, wscale: torch.Tensor, stride: int = 1,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The earlier design of :func:`conv3x3_s8` on ``mma.sync``
    (``csrc/conv3x3_int8.cu``, :func:`conv_plan`), on no path, kept to be
    timed beside it: the same arguments (``wq`` as it is, no packing) and
    result; its own launch count."""
    if _s8_route('conv3x3_s8_mma', xq, wq, out_dtype):
        return conv3x3_s8_ref(xq, x_scale, wq, wscale, stride, out_dtype)
    n, h, w, c, co, y = _check_s8(xq, x_scale, wq, wscale, stride,
                                  out_dtype)
    err = build.library().fvt_conv3x3_s8_mma_forward(
        xq.data_ptr(), wq.data_ptr(), wscale.data_ptr(), x_scale.data_ptr(),
        y.data_ptr(), int(out_dtype == torch.bfloat16), n, h, w, c, co,
        stride, torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, f'conv3x3_s8_mma kernel (N={n}, H={h}, W={w}, C={c}, '
                     f'Co={co}, stride={stride})')
    conv3x3_s8_mma.launches += 1
    return y


conv3x3_s8_mma.launches = 0


def conv3x3_int8(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                 out_dtype: torch.dtype = torch.bfloat16,
                 x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fvt_tpu``'s ``conv3x3_int8``: x (N, H, W, C) float32 or bfloat16,
    kernel HWIO (3, 3, C, Co) float; 'same' padding, ``stride`` 1 or 2.
    ``x_scale``: a calibrated per-tensor scale (one float32 value on x's
    device), else the call's own.  :func:`quantize_int8` then
    :func:`conv3x3_s8`: kernels on the card, plain versions on the CPU."""
    _check_x('conv3x3_int8', x)
    if tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f'kernel {tuple(kernel.shape)}: a 3x3 HWIO kernel')
    refuse_grad('conv3x3_int8', x, kernel)
    wq, wscale = quantize_weights(kernel)
    xq, scale, _ = quantize_int8(x, x_scale)
    return conv3x3_s8(xq, scale, wq, wscale, stride, out_dtype)


def conv3x3_int8_ref(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                     out_dtype: torch.dtype = torch.bfloat16,
                     x_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Plain version of :func:`conv3x3_int8` on any device: the weights and
    x quantised in PyTorch (:func:`quantize_symmetric`), the sum in
    float64, one rounding to float32, the scaling, then ``out_dtype``."""
    wq, wscale = quantize_weights(kernel)
    if x_scale is None:
        xq, x_scale = quantize_symmetric(x)
    else:
        xq = quantize_with(x, x_scale.reshape(()))
    return conv3x3_s8_ref(xq, x_scale, wq, wscale, stride, out_dtype)


def conv3x3_int8_9mm(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                     out_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """``fvt_tpu``'s record of the conv as nine shifted int8 matmuls, in
    plain PyTorch: both operands quantised by :func:`quantize_symmetric`
    (x per tensor, dynamic), the nine products summed by
    :func:`tap_sum`, then :func:`dequantize`."""
    n, h, w, _ = x.shape
    co = kernel.shape[3]
    wq, wscale = quantize_weights(kernel)
    xq, xscale = quantize_symmetric(x)
    shape = (n, out_size(h, stride), out_size(w, stride), co)
    return dequantize(tap_sum(xq, wq, stride), xscale, wscale, shape,
                      out_dtype)


def s8_conv_ops(n: int, h: int, w: int, c: int, co: int,
                stride: int) -> float:
    """int8 operations (a multiply and an add each) of the conv."""
    return 2.0 * n * out_size(h, stride) * out_size(w, stride) * co * 9 * c

