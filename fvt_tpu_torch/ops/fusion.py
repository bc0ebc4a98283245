"""Fused eval-mode LFAN multimodal fusion: CUDA kernels and plain version.

Counterpart of ``fvt_tpu/ops/fusion_pallas.py::fused_multimodal_fusion``:
per frame, a packed qkv projection per modality (head-major, ``[q|k|v]``
inside each head), softmax attention over the M modality slots per head,
the +V residual, ``o_proj`` and a LayerNorm (eps 1e-5, no residual).
Layouts follow the JAX package: ``x[m] (B, T, C_m)``,
``wqkv[m] (C_m, 3E)``, ``wo (E*M, E*M)``; the output is ``(B, T, E*M)``,
head-major then modality.

:func:`fused_multimodal_fusion` runs :func:`fused_multimodal_fusion_ref`
for tensors on the CPU; for float32 CUDA tensors it launches
``fvt_fusion_tf32x3_forward`` (``csrc/fusion_tf32x3.cu``) or raises: one
launch for 1 to 7 modalities and any E*M, the qkv projections and
``o_proj`` as split-TF32 ``wgmma`` products, the attention in registers,
the LayerNorm in the epilogue, on weights split and packed by
:func:`pack_fusion_weights` (kept by
``models.fusion.MultimodalTransformerEncoder.eval_weights``).
:func:`fused_multimodal_fusion_tf32x3_ref` emulates what it computes.
``fused_multimodal_fusion.launches`` counts its launches.
:func:`fused_multimodal_fusion_simt`, the earlier kernel on the CUDA cores
(``csrc/fusion.cu``, on the route :func:`fusion_route` picks), stays for
measurements: no model path calls it.  The kernels are eval-only;
training runs :func:`multimodal_attention_ref` under autograd.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fvt_tpu_torch.kernels import build
from fvt_tpu_torch.ops.conv import pack_taps_tf32, split_tf32

LN_EPS = 1e-5
# the seven LFAN modalities with embedding sizes (kMaxModal)
MAX_MODALITIES = 7
# the split-TF32 kernel (csrc/fusion_tf32x3.cu): head dims a slice (its qkv
# product has 3 x 16 columns), o's columns a chunk, the channels a step of
# its products, frames a tile, and the widest E*M whose cat it keeps in
# shared memory (wider, cat goes through a device workspace: TILE_ROWS x
# O_CHUNK floats a block of 32 columns and launched block)
HEAD_SLICE, O_CHUNK, STEP, TILE_ROWS, SHARED_WIDTH = 16, 32, 32, 64, 256
# the SIMT kernel's frames a tile and shared memory (csrc/fusion.cu)
TILE_FRAMES = 8
MAX_SMEM = 227 * 1024
# a route's weight matrices read from global memory, a bit each; the
# kernel's three routes, in the order tried
WQKV_GLOBAL, WO_GLOBAL = 1, 2
ROUTES = (0, WO_GLOBAL, WQKV_GLOBAL | WO_GLOBAL)


def smem_bytes(widths: Sequence[int], modal_dim: int, route: int) -> int:
    """Shared memory of the SIMT kernel's layout (``Smem`` in
    ``csrc/fusion.cu``) for modality widths ``widths`` on ``route``: the
    weight matrices not read from global memory, the biases and the
    LayerNorm's vectors, and a tile's x, qkv, attention output and
    o_proj output."""
    ctot, m = sum(widths), len(widths)
    e3, em = 3 * modal_dim, modal_dim * m
    floats = ((0 if route & WQKV_GLOBAL else ctot * e3) + m * e3
              + (0 if route & WO_GLOBAL else em * em) + 3 * em
              + TILE_FRAMES * (ctot + m * e3 + 2 * em))
    return 4 * floats


@functools.lru_cache(maxsize=None)
def fusion_route(widths: Tuple[int, ...], modal_dim: int) -> int:
    """The SIMT kernel's route: the first of :data:`ROUTES` whose layout
    fits shared memory: 0 (all
    weights staged, the main path's) where it can, then Wo read from
    global memory, then both Wo and Wqkv.  Raises where none fits."""
    for route in ROUTES:
        if smem_bytes(widths, modal_dim, route) <= MAX_SMEM:
            return route
    raise ValueError(f'widths {list(widths)}, modal_dim {modal_dim}: a '
                     f'tile\'s activations alone leave the kernel\'s shared '
                     f'memory')


def _slot_attention(qkv: Sequence[torch.Tensor], *, modal_dim: int,
                    num_heads: int) -> torch.Tensor:
    """M packed ``qkv`` (B, T, 3E), head-major with ``[q|k|v]`` inside each
    head -> the attention over the modality slots with the +V residual,
    ``cat`` (B, T, E*M), head-major then modality."""
    b, t, _ = qkv[0].shape
    m = len(qkv)
    hd = modal_dim // num_heads
    # (B, T, M, H, 3hd) -> q, k, v each (B, T, H, M, hd)
    q, k, v = torch.stack(qkv, dim=2).reshape(
        b, t, m, num_heads, 3 * hd).transpose(2, 3).split(hd, dim=-1)
    attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    return (attn @ v + v).reshape(b, t, modal_dim * m)


def multimodal_attention_ref(xs: Sequence[torch.Tensor],
                             wqkv: Sequence[torch.Tensor],
                             bqkv: Sequence[torch.Tensor],
                             wo: torch.Tensor, bo: torch.Tensor, *,
                             modal_dim: int, num_heads: int) -> torch.Tensor:
    """The attention over the modality slots up to ``o_proj``, before the
    LayerNorm: plain, differentiable PyTorch (the train path puts its
    dropout between the two, ``fvt_tpu/models/fusion.py:84-90``)."""
    qkv = [x @ w + bias for x, w, bias in zip(xs, wqkv, bqkv)]
    return _slot_attention(qkv, modal_dim=modal_dim,
                           num_heads=num_heads) @ wo + bo


def fused_multimodal_fusion_ref(xs: Sequence[torch.Tensor],
                                wqkv: Sequence[torch.Tensor],
                                bqkv: Sequence[torch.Tensor],
                                wo: torch.Tensor, bo: torch.Tensor,
                                ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                                *, modal_dim: int,
                                num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the fusion block (same math, layouts)."""
    o = multimodal_attention_ref(xs, wqkv, bqkv, wo, bo,
                                 modal_dim=modal_dim, num_heads=num_heads)
    return F.layer_norm(o, (o.shape[-1],), ln_scale, ln_bias, LN_EPS)


def refuse_grad(*tensors: torch.Tensor) -> None:
    """The kernels are eval-only, as the Pallas kernel is: raises for an
    input that requires grad while grad mode is on."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError('fused_multimodal_fusion has no backward: call '
                           'it under torch.no_grad(), or take the train '
                           'path of MultimodalTransformerEncoder')


def _split_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` as the split-TF32 kernel sums it: ``(a_hi @ w_lo + a_lo @
    w_hi) + a_hi @ w_hi`` of the parts of ``ops.conv.split_tf32`` (each
    product exact in float32, the sums in float32, ``lo*lo`` dropped)."""
    ah, al = split_tf32(a.contiguous())
    wh, wl = split_tf32(w.contiguous())
    return (ah @ wl + al @ wh) + ah @ wh


def fused_multimodal_fusion_tf32x3_ref(xs: Sequence[torch.Tensor],
                                       wqkv: Sequence[torch.Tensor],
                                       bqkv: Sequence[torch.Tensor],
                                       wo: torch.Tensor, bo: torch.Tensor,
                                       ln_scale: torch.Tensor,
                                       ln_bias: torch.Tensor, *,
                                       modal_dim: int,
                                       num_heads: int) -> torch.Tensor:
    """What the split-TF32 kernel computes, emulated on float32 tensors:
    the qkv projections and ``o_proj`` as :func:`_split_mm` (``cat`` split
    again where the kernel stores it), the attention and the LayerNorm as
    :func:`fused_multimodal_fusion_ref`.  The kernel sums each product in
    another order (per 8-channel slice, the three parts in turn)."""
    qkv = [_split_mm(x, w) + bias for x, w, bias in zip(xs, wqkv, bqkv)]
    cat = _slot_attention(qkv, modal_dim=modal_dim, num_heads=num_heads)
    o = _split_mm(cat, wo) + bo
    return F.layer_norm(o, (o.shape[-1],), ln_scale, ln_bias, LN_EPS)


def check_tf32x3_shape(widths: Sequence[int], modal_dim: int,
                       num_heads: int) -> None:
    """Raises ValueError for a fusion the split-TF32 kernel does not take:
    other than 1 to 7 modalities, a width C_m or E not a multiple of 4, or
    E not a multiple of the heads.  Any C_m, head size and E*M are taken
    (C_m streams through the kernel's ring; a head's dims go in slices of
    ``HEAD_SLICE``; cat goes through a workspace above ``SHARED_WIDTH``)."""
    m = len(widths)
    if not 1 <= m <= MAX_MODALITIES:
        raise ValueError(f'{m} modalities: the kernel takes 1 to '
                         f'{MAX_MODALITIES}')
    if modal_dim <= 0 or num_heads <= 0 or modal_dim % num_heads \
            or modal_dim % 4:
        raise ValueError(f'modal_dim {modal_dim}: the kernel takes a '
                         f'multiple of 4 and of num_heads {num_heads}')
    if any(c <= 0 or c % 4 for c in widths):
        raise ValueError(f'widths {list(widths)}: the kernel takes '
                         f'multiples of 4')


def head_columns(modal_dim: int, num_heads: int) -> torch.Tensor:
    """The columns of a packed Wqkv (C, 3E) that the kernel's (head h,
    slice ds of ``HEAD_SLICE`` dims) products take, ``(H*S, 48)`` with S =
    ceil(hd / 16): column ``16*part + t`` of row ``h*S + ds`` is
    ``h*3*hd + part*hd + 16*ds + t`` (``part`` 0, 1, 2 for q, k, v), or
    -1 (a zero weight) where ``16*ds + t >= hd``."""
    hd = modal_dim // num_heads
    s = -(-hd // HEAD_SLICE)
    h, ds, part, t = torch.meshgrid(
        torch.arange(num_heads), torch.arange(s), torch.arange(3),
        torch.arange(HEAD_SLICE), indexing='ij')
    dim = HEAD_SLICE * ds + t
    cols = torch.where(dim < hd, h * 3 * hd + part * hd + dim, -1)
    return cols.reshape(num_heads * s, 3 * HEAD_SLICE)


def pack_fusion_weights(wqkv: Sequence[torch.Tensor],
                        bqkv: Sequence[torch.Tensor], wo: torch.Tensor, *,
                        modal_dim: int, num_heads: int) -> dict:
    """The weights as the split-TF32 kernel reads them, float32 on their
    device.  ``'wqkv'``: per modality the ``(hi, lo)`` parts
    (``ops.conv.split_tf32``) of Wqkv_m's columns in the order of
    :func:`head_columns`, each ``(H*S, 4*ceil(C_m/32), 2, 6, 8, 4)`` with
    ``part[g, s, c, n8, n, k] = split(w[8*s + 4*c + k, cols[g, 8*n8 +
    n]])``, zeros where the channel is beyond C_m (the kernel's steps take
    32) or the column is -1; ``'bqkv'``: per modality its bias in the same
    columns, ``(H*S, 48)``; ``'wo'``: the parts of Wo (E*M, E*M) for column
    chunks of 32, ``(ceil(E*M/32), 4*ceil(E*M/32), 2, 4, 8, 4)``
    (``ops.conv.pack_taps_tf32``'s layout), zero rows and columns beyond
    E*M.  A module derives them once a parameter
    version and keeps them (``MultimodalTransformerEncoder.eval_weights``);
    :func:`fused_multimodal_fusion` derives them per call otherwise."""
    cols = head_columns(modal_dim, num_heads).to(wo.device)
    g = cols.shape[0]
    pads = cols < 0
    packed = {'wqkv': [], 'bqkv': []}
    for w, b in zip(wqkv, bqkv):
        sel = w[:, cols.clamp_min(0)].masked_fill(pads, 0.0)  # (C, g, 48)
        sel = F.pad(sel, (0, 0, 0, 0, 0, -w.shape[0] % STEP))
        parts = pack_taps_tf32(sel.permute(1, 0, 2), 3 * HEAD_SLICE)
        packed['wqkv'].append(tuple(
            p.reshape(-1, g, 2, 6, 8, 4).transpose(0, 1).contiguous()
            for p in parts))
        packed['bqkv'].append(b[cols.clamp_min(0)].masked_fill(pads, 0.0)
                              .contiguous())
    wo = F.pad(wo, (0, 0, 0, -wo.shape[0] % STEP))
    packed['wo'] = tuple(p.reshape(p.shape[0], p.shape[1], 2, 4, 8, 4)
                         for p in pack_taps_tf32(wo[None], O_CHUNK))
    return packed


def _check_packed(packed: dict, widths: Sequence[int], em: int,
                  groups: int, device) -> list:
    """``(name, tensor, shape)`` of every packed weight the kernel reads."""
    checks = []
    for i, (c, pair, bias) in enumerate(zip(widths, packed['wqkv'],
                                            packed['bqkv'])):
        shape = (groups, 4 * -(-c // STEP), 2, 6, 8, 4)
        checks += [(f'wqkv[{i}] {part}', t, shape)
                   for part, t in zip(('hi', 'lo'), pair)]
        checks.append((f'bqkv[{i}] packed', bias, (groups, 3 * HEAD_SLICE)))
    shape = (-(-em // O_CHUNK), 4 * -(-em // STEP), 2, 4, 8, 4)
    checks += [(f'wo {part}', t, shape)
               for part, t in zip(('hi', 'lo'), packed['wo'])]
    return checks


def fused_multimodal_fusion(xs: Sequence[torch.Tensor],
                            wqkv: Sequence[torch.Tensor],
                            bqkv: Sequence[torch.Tensor],
                            wo: torch.Tensor, bo: torch.Tensor,
                            ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                            *, modal_dim: int, num_heads: int,
                            packed: Optional[dict] = None) -> torch.Tensor:
    """xs: M tensors (B, T, C_m) in modality order; wqkv[m] (C_m, 3E),
    bqkv[m] (3E); wo (E*M, E*M); bo, ln_scale, ln_bias (E*M).  Returns
    (B, T, E*M).  ``packed``: :func:`pack_fusion_weights` of the weights
    when the caller keeps it (the kernel then reads it in place of wqkv,
    bqkv and wo); derived here otherwise.  Eval only: the kernel has no
    backward, as the Pallas kernel has none, so inputs that require grad
    are refused while grad mode is on."""
    x0 = xs[0]
    refuse_grad(*xs, *wqkv, *bqkv, wo, bo, ln_scale, ln_bias)
    if x0.device.type == 'cpu':
        return fused_multimodal_fusion_ref(
            xs, wqkv, bqkv, wo, bo, ln_scale, ln_bias, modal_dim=modal_dim,
            num_heads=num_heads)
    if x0.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x0.device}')
    widths = tuple(x.shape[-1] for x in xs)
    check_tf32x3_shape(widths, modal_dim, num_heads)
    m = len(xs)
    b, t, _ = x0.shape
    em = modal_dim * m
    checks = [(f'xs[{i}]', x, (b, t, c)) for i, (x, c) in
              enumerate(zip(xs, widths))]
    checks += [('bo', bo, (em,)), ('ln_scale', ln_scale, (em,)),
               ('ln_bias', ln_bias, (em,))]
    if packed is None:
        if len(wqkv) != m or len(bqkv) != m:
            raise ValueError('one qkv weight and bias per modality')
        for i, (w, bias, c) in enumerate(zip(wqkv, bqkv, widths)):
            checks += [(f'wqkv[{i}]', w, (c, 3 * modal_dim)),
                       (f'bqkv[{i}]', bias, (3 * modal_dim,))]
        checks.append(('wo', wo, (em, em)))
        packed = pack_fusion_weights(wqkv, bqkv, wo, modal_dim=modal_dim,
                                     num_heads=num_heads)
    if len(packed['wqkv']) != m or len(packed['bqkv']) != m:
        raise ValueError('packed weights for another number of modalities')
    groups = num_heads * -(-(modal_dim // num_heads) // HEAD_SLICE)
    checks += _check_packed(packed, widths, em, groups, x0.device)
    for name, arr, shape in checks:
        build.check_tensor(name, arr, shape, x0.device)
    out = torch.empty((b, t, em), device=x0.device, dtype=torch.float32)
    if b * t == 0:
        return out
    ws, ws_blocks = None, 0
    if em > SHARED_WIDTH:  # cat through a workspace, a block's tile each
        ws_blocks = min(-(-b * t // TILE_ROWS), _sm_count(x0.device.index))
        ws = torch.empty((ws_blocks, -(-em // O_CHUNK) * O_CHUNK * TILE_ROWS),
                         device=x0.device, dtype=torch.float32)
    ptrs = (ctypes.c_void_p * (4 * m))(
        *(x.data_ptr() for x in xs),
        *(pair[0].data_ptr() for pair in packed['wqkv']),
        *(pair[1].data_ptr() for pair in packed['wqkv']),
        *(bias.data_ptr() for bias in packed['bqkv']))
    err = build.library().fvt_fusion_tf32x3_forward(
        ptrs, _widths(widths), packed['wo'][0].data_ptr(),
        packed['wo'][1].data_ptr(), bo.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), ws_blocks, b * t, m,
        modal_dim, num_heads, torch.cuda.current_stream(x0.device).cuda_stream)
    if err:  # the message is built only for an error
        build.check(err, f'fusion split-TF32 kernel (N={b * t}, M={m}, '
                         f'E={modal_dim}, H={num_heads}, C={widths})')
    fused_multimodal_fusion.launches += 1
    return out


fused_multimodal_fusion.launches = 0


def fused_multimodal_fusion_simt(xs: Sequence[torch.Tensor],
                                 wqkv: Sequence[torch.Tensor],
                                 bqkv: Sequence[torch.Tensor],
                                 wo: torch.Tensor, bo: torch.Tensor,
                                 ln_scale: torch.Tensor,
                                 ln_bias: torch.Tensor, *, modal_dim: int,
                                 num_heads: int) -> torch.Tensor:
    """The earlier kernel on the CUDA cores (``csrc/fusion.cu``), kept to
    be timed beside :func:`fused_multimodal_fusion`'s: no model path calls
    it.  The arguments are :func:`fused_multimodal_fusion`'s, unpacked; it
    runs on the route :func:`fusion_route` picks.  The plain version on
    the CPU; ``fused_multimodal_fusion_simt.launches`` counts its
    launches."""
    x0 = xs[0]
    refuse_grad(*xs, *wqkv, *bqkv, wo, bo, ln_scale, ln_bias)
    if x0.device.type == 'cpu':
        return fused_multimodal_fusion_ref(
            xs, wqkv, bqkv, wo, bo, ln_scale, ln_bias, modal_dim=modal_dim,
            num_heads=num_heads)
    if x0.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x0.device}')
    m = len(xs)
    if not 1 <= m <= MAX_MODALITIES:
        raise ValueError(f'{m} modalities: the kernel takes 1 to '
                         f'{MAX_MODALITIES}')
    if len(wqkv) != m or len(bqkv) != m:
        raise ValueError('one qkv weight and bias per modality')
    if modal_dim % num_heads or modal_dim % 4:
        raise ValueError(f'modal_dim {modal_dim}: the kernel takes a '
                         f'multiple of 4 and of num_heads {num_heads}')
    if any(x.shape[-1] % 4 for x in xs):
        raise ValueError(f'widths {[x.shape[-1] for x in xs]}: the kernel '
                         f'takes multiples of 4')
    b, t, _ = x0.shape
    em = modal_dim * m
    checks = [('wo', wo, (em, em)), ('bo', bo, (em,)),
              ('ln_scale', ln_scale, (em,)), ('ln_bias', ln_bias, (em,))]
    for i, (x, w, bias) in enumerate(zip(xs, wqkv, bqkv)):
        c = x.shape[-1]
        checks += [(f'xs[{i}]', x, (b, t, c)),
                   (f'wqkv[{i}]', w, (c, 3 * modal_dim)),
                   (f'bqkv[{i}]', bias, (3 * modal_dim,))]
    for name, arr, shape in checks:
        build.check_tensor(name, arr, shape, x0.device)
    out = torch.empty((b, t, em), device=x0.device, dtype=torch.float32)
    if b * t == 0:
        return out
    widths = tuple(x.shape[-1] for x in xs)
    route = fusion_route(widths, modal_dim)
    ptrs = (ctypes.c_void_p * (3 * m))(
        *(a.data_ptr() for ts in (xs, wqkv, bqkv) for a in ts))
    err = build.library().fvt_fusion_forward(
        ptrs, _widths(widths), wo.data_ptr(), bo.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), out.data_ptr(), b * t, m,
        modal_dim, num_heads, route,
        torch.cuda.current_stream(x0.device).cuda_stream)
    if err:  # the message is built only for an error
        build.check(err, f'fusion SIMT kernel (N={b * t}, M={m}, '
                         f'E={modal_dim}, H={num_heads}, C={widths}, '
                         f'route={route})')
    fused_multimodal_fusion_simt.launches += 1
    return out


fused_multimodal_fusion_simt.launches = 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _widths(widths: Tuple[int, ...]) -> ctypes.Array:
    """The widths as the C entries read them (a host int array), made once
    a tuple: the wrapper's host time is on a dispatch's path."""
    return (ctypes.c_int * len(widths))(*widths)
