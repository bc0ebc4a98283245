"""Fused TCN temporal block, eval and train: CUDA kernels and plain
versions.

Counterpart of ``fvt_tpu/ops/tcn_pallas.py`` (``fused_temporal_block``,
``tcn_forward_pallas``, ``fused_temporal_block_train``).  In eval mode one
block computes

    y = leaky(leaky(conv2(leaky(conv1(x)))) + res)

with causal dilated convs (left pad ``(K-1)*dilation``), leaky slope 0.01
and ``res`` the 1x1 downsample of ``x`` (or ``x`` itself).  Layouts follow
the JAX package: ``x (B, T, Cin)``, ``w1 (K, Cin, Cout)``,
``w2 (K, Cout, Cout)``, ``wd (Cin, Cout)``.

:func:`fused_temporal_block` runs :func:`fused_temporal_block_ref` for a
tensor on the CPU; for a float32 CUDA tensor it launches
``fvt_tcn_block_tf32x3_forward`` (``csrc/tcn_block_tf32x3.cu``) or raises:
the two convs (and the downsample, where there is one) each a launch of a
split-TF32 ``wgmma`` causal conv, h and r through workspaces.
:func:`fused_temporal_block_tf32x3_ref` emulates what it computes.
``fused_temporal_block.launches`` counts its calls on the card, one for
the launches of a block.  :func:`fused_temporal_block_simt`, the earlier
one-launch kernel on the CUDA cores (``csrc/tcn_block.cu``), stays for
measurements: no model path calls it.

:func:`fused_temporal_block_train` is the differentiable train-mode block
with dropout masks and the residual stream passed in
(``tcn_pallas.py:328-359``): for float32 CUDA tensors a
``torch.autograd.Function`` whose forward and backward launch the
split-TF32 ``wgmma`` kernels of ``csrc/tcn_block_train_tf32x3.cu`` or
raise (counted in ``.launches_fwd`` and ``.launches_bwd``, one a C entry
call), for CPU tensors :func:`fused_temporal_block_train_ref` under
ordinary autograd.  :func:`fused_temporal_block_train_tf32x3_ref` and
:func:`_block_bwd_tf32x3_ref` emulate what the kernels compute;
:func:`_block_bwd_ref` spells the backward's arithmetic in plain PyTorch,
so the CPU tests hold the formula against autograd.
:func:`fused_temporal_block_train_simt`, the earlier kernels on the CUDA
cores (``csrc/tcn_block_train.cu``), stays for measurements: no model
path calls it.
"""
from __future__ import annotations

import functools
import math
import types
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fvt_tpu_torch.kernels import build
from fvt_tpu_torch.ops.conv import pack_taps_tf32, split_tf32

NEG_SLOPE = 0.01


def _leaky(z: torch.Tensor) -> torch.Tensor:
    """leaky_relu whose derivative at 0 is 1, the rule of the Pallas
    backward (``z >= 0``, ``tcn_pallas.py:199-200``) and of the CUDA one;
    ``F.leaky_relu``'s autograd takes the slope there."""
    return torch.where(z >= 0, z, z * NEG_SLOPE)


def _dleaky(z: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(z).masked_fill_(z < 0, NEG_SLOPE)


def _causal_conv(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 dilation: int) -> torch.Tensor:
    """v (B, T, C), w (K, C, Co), left pad (K-1)*dilation -> (B, T, Co)."""
    pad = (w.shape[0] - 1) * dilation
    v = F.pad(v.transpose(1, 2), (pad, 0))
    return F.conv1d(v, w.permute(2, 1, 0), b,
                    dilation=dilation).transpose(1, 2)


def fused_temporal_block_ref(x: torch.Tensor, w1: torch.Tensor,
                             b1: torch.Tensor, w2: torch.Tensor,
                             b2: torch.Tensor,
                             wd: Optional[torch.Tensor] = None,
                             bd: Optional[torch.Tensor] = None, *,
                             kernel_size: int, dilation: int) -> torch.Tensor:
    """Plain PyTorch version of the fused block (same math, same layouts)."""
    pad = (kernel_size - 1) * dilation

    def conv(v, w, b):  # v (B, T, C), w (K, C, Co) -> (B, T, Co)
        v = F.pad(v.transpose(1, 2), (pad, 0))
        y = F.conv1d(v, w.permute(2, 1, 0), b, dilation=dilation)
        return y.transpose(1, 2)

    h = F.leaky_relu(conv(x, w1, b1), NEG_SLOPE)
    net = F.leaky_relu(conv(h, w2, b2), NEG_SLOPE)
    res = x if wd is None else x @ wd + bd
    return F.leaky_relu(net + res, NEG_SLOPE)


def _split_conv(v: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                dilation: int, *, causal: bool = True) -> torch.Tensor:
    """A causal conv (:func:`_causal_conv`) as the split-TF32 kernel sums
    it: per group of taps (:func:`tap_groups`, one group at the model's
    shapes), ``(v_hi * w_lo + v_lo * w_hi) + v_hi * w_hi`` of the parts of
    ``ops.conv.split_tf32`` (each product exact in float32, the sums in
    float32, ``lo*lo`` dropped), the groups added in order, then the bias
    (none where ``b`` is None).  A group's zero taps add exact zeros and
    are left out.  ``causal=False``: the anti-causal conv the train
    kernel's backward runs, tap k reading frame ``t + k*dilation`` (zeros
    from T on)."""
    k = w.shape[0]
    pad = (k - 1) * dilation
    g, groups = tap_groups(k, dilation)
    t = v.shape[1]
    vh, vl = (F.pad(p.transpose(1, 2), (pad, 0) if causal else (0, pad))
              for p in split_tf32(v))
    wh, wl = split_tf32(w)
    out = None
    for i in range(groups):
        # taps i*g .. of the group read from frame t - pad + i*g*dilation
        first = i * g * dilation

        def conv(p, q):
            y = F.conv1d(p[..., first:], q[i * g:(i + 1) * g].permute(2, 1, 0),
                         dilation=dilation)
            return y[..., :t].transpose(1, 2)

        part = (conv(vh, wl) + conv(vl, wh)) + conv(vh, wh)
        out = part if out is None else out + part
    return out if b is None else out + b


def fused_temporal_block_tf32x3_ref(x: torch.Tensor, w1: torch.Tensor,
                                    b1: torch.Tensor, w2: torch.Tensor,
                                    b2: torch.Tensor,
                                    wd: Optional[torch.Tensor] = None,
                                    bd: Optional[torch.Tensor] = None, *,
                                    kernel_size: int,
                                    dilation: int) -> torch.Tensor:
    """What the split-TF32 kernel computes, emulated on float32 tensors:
    both convs and the downsample (one tap) as :func:`_split_conv`, h
    split again where conv2 stages it, leaky and the residual as
    :func:`fused_temporal_block_ref`.  The kernel's sums run in another
    order (per 8-channel slice, then over the slices)."""
    if w1.shape[0] != kernel_size:
        raise ValueError(f'kernel_size {kernel_size} != weight taps '
                         f'{w1.shape[0]}')
    h = _leaky(_split_conv(x, w1, b1, dilation))
    net = _leaky(_split_conv(h, w2, b2, dilation))
    res = x if wd is None else _split_conv(x, wd[None], bd, 1)
    return _leaky(net + res)


# the split-TF32 kernel (csrc/tcn_block_tf32x3.cu): output frames and
# output channels a tile, the rows one TMA box may bring (the tile and its
# causal halo), and the taps of its instantiations
ROW_TILE, COLUMN_TILE, MAX_BOX, MAX_TAPS = 64, 64, 256, 9
# a halo beyond this makes a TMA coordinate overflow (the C entry refuses)
MAX_HALO = 2 ** 30
# its launches, a bit each
CONV1, DOWNSAMPLE, CONV2 = 1, 2, 4
ALL = CONV1 | DOWNSAMPLE | CONV2


def tap_groups(kernel_size: int, dilation: int) -> Tuple[int, int]:
    """``(G, groups)``: how the split-TF32 kernel takes the K taps of a
    causal conv at ``dilation``, the plan its C entry makes too.  Each
    reduction step stages one TMA box for one group of G taps, ``ROW_TILE
    + (G-1)*dilation`` rows from frame ``t0 - (K-1)*dilation +
    g*G*dilation``: G is at most ``MAX_TAPS`` (the instantiations) and
    keeps the box within ``MAX_BOX`` rows, the groups are as few as that
    allows and as even as they can be, and the last group's taps beyond K
    are zero weights (:func:`pack_block_weights`).  One group, G = K,
    wherever K <= 9 and the whole halo fits one box: every block of the
    model."""
    g_max = min(MAX_TAPS, 1 + (MAX_BOX - ROW_TILE) // dilation)
    groups = -(-kernel_size // g_max)
    return -(-kernel_size // groups), groups


def tap_boxes(kernel_size: int, dilation: int, *, causal: bool = True
              ) -> list:
    """The split-TF32 conv kernel's reduction steps over one 8-channel
    slice of a row tile, as ``(start, rows, taps)`` a group of
    :func:`tap_groups`: its TMA box starts ``start`` frames after the
    tile's first frame and brings ``rows`` frames, and kernel tap ``j`` of
    the group (weights of packed tap ``g*G + j``) reads its rows from
    ``j*dilation`` on.  Causal (tap k reads frame ``t - (K-1)*dilation +
    k*dilation``): start ``-(K-1)*dilation + g*G*dilation``.  Anti-causal
    (the train backward's transposed convs, packed tap k' =
    ``w[K-1-k']^T`` reading frame ``t + k'*dilation``): start
    ``g*G*dilation``.  ``taps`` lists the group's packed taps below K (the
    rest are zero weights).  ``csrc/tcn_conv_tf32x3.cuh``'s producer
    makes the same plan."""
    g, groups = tap_groups(kernel_size, dilation)
    lead = (kernel_size - 1) * dilation if causal else 0
    return [(-lead + i * g * dilation, ROW_TILE + (g - 1) * dilation,
             list(range(i * g, min((i + 1) * g, kernel_size))))
            for i in range(groups)]


def check_tf32x3_shape(cin: int, cout: int, kernel_size: int,
                       dilation: int) -> None:
    """Raises ValueError for a block the split-TF32 kernel does not take:
    Cout not a multiple of 8 (``wgmma``'s n), or no taps, no dilation or
    a halo ``(K-1)*dilation`` from ``MAX_HALO`` on.  Any Cin is taken
    (:func:`pad_channels` pads it), and any K and dilation below that
    (:func:`tap_groups`)."""
    if cout % 8 or kernel_size < 1 or dilation < 1 \
            or (kernel_size - 1) * dilation >= MAX_HALO:
        raise ValueError(
            f'the split-TF32 TCN kernel does not take Cin={cin}, '
            f'Cout={cout}, K={kernel_size}, dilation={dilation}: Cout must '
            f'be a multiple of 8, K and dilation at least 1 and '
            f'(K-1)*dilation below {MAX_HALO}')


def pad_taps(w: torch.Tensor, dilation: int) -> torch.Tensor:
    """w (K, C, Co) with zero taps after its K up to ``G * groups`` of
    :func:`tap_groups`: the taps the kernel's steps read.  w itself where
    there are none."""
    g, groups = tap_groups(w.shape[0], dilation)
    extra = g * groups - w.shape[0]
    return w if not extra else F.pad(w, (0, 0, 0, 0, 0, extra))


def pad_channels(x: torch.Tensor) -> torch.Tensor:
    """x (B, T, Cin) with zero channels up to a multiple of 4, what the
    kernel's tensor map needs (16-byte rows); x itself where Cin is one.
    The packed weights carry zero rows there (``ops.conv.pack_taps_tf32``
    pads to whole slices of 8), so the sums are unchanged."""
    return x if x.shape[-1] % 4 == 0 else F.pad(x, (0, -x.shape[-1] % 4))


def pack_block_weights(w1: torch.Tensor, w2: torch.Tensor,
                       wd: Optional[torch.Tensor] = None, *,
                       dilation: int = 1) -> tuple:
    """``((w1_hi, w1_lo), (w2_hi, w2_lo), (wd_hi, wd_lo) or None)``: the
    block's weights split and packed for the split-TF32 kernel at column
    tiles of ``COLUMN_TILE`` (``ops.conv.pack_taps_tf32``; the convs' taps
    as :func:`pad_taps` gives them at ``dilation``, the downsample as one
    tap).  A module derives them once a parameter version and keeps
    them (``models.tcn.TemporalBlock.eval_weights``);
    :func:`fused_temporal_block` derives them per call otherwise."""
    return (pack_taps_tf32(pad_taps(w1, dilation), COLUMN_TILE),
            pack_taps_tf32(pad_taps(w2, dilation), COLUMN_TILE),
            None if wd is None else pack_taps_tf32(wd[None], COLUMN_TILE))


def launch_tf32x3(x: torch.Tensor, packed: tuple, b1: torch.Tensor,
                  b2: torch.Tensor, bd: Optional[torch.Tensor],
                  h: torch.Tensor, r: Optional[torch.Tensor],
                  out: torch.Tensor, *, kernel_size: int, dilation: int,
                  stages: int = ALL) -> None:
    """Launches the ``stages`` of the split-TF32 block on the current
    stream: conv1 x -> h, the downsample x -> r (with one), conv2 h, r or
    x -> out.  ``x`` as :func:`pad_channels` returns it, ``packed`` as
    :func:`pack_block_weights`.  Checks every tensor and raises on a CUDA
    error; counts nothing (a measurement may launch one conv alone)."""
    b, t, c = x.shape
    cout = out.shape[-1]
    tiles = -(-cout // COLUMN_TILE)
    w1, w2, wd = packed
    g, groups = tap_groups(kernel_size, dilation)
    tensors = [('x', x, (b, t, c)), ('h', h, (b, t, cout)),
               ('out', out, (b, t, cout)), ('b1', b1, (cout,)),
               ('b2', b2, (cout,))]
    for name, pair, taps, cin in (('w1', w1, g * groups, c),
                                  ('w2', w2, g * groups, cout),
                                  ('wd', wd, 1, c)):
        if pair is not None:
            shape = (tiles, -(-cin // 8), taps, 2, COLUMN_TILE // 8, 8, 4)
            tensors += [(name, part, shape) for part in pair]
    if wd is not None:
        tensors += [('bd', bd, (cout,)), ('r', r, (b, t, cout))]
    for name, arr, shape in tensors:
        build.check_tensor(name, arr, shape, x.device)
    none = (None, None)
    err = build.library().fvt_tcn_block_tf32x3_forward(
        x.data_ptr(), w1[0].data_ptr(), w1[1].data_ptr(), b1.data_ptr(),
        w2[0].data_ptr(), w2[1].data_ptr(), b2.data_ptr(),
        *(none if wd is None else (wd[0].data_ptr(), wd[1].data_ptr())),
        None if wd is None else bd.data_ptr(), h.data_ptr(),
        None if wd is None else r.data_ptr(), out.data_ptr(), b, t, c,
        cout, kernel_size, dilation, stages,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:  # the message is built only for an error
        build.check(err, f'tcn_block split-TF32 kernel (B={b}, T={t}, '
                         f'C={c}, Cout={cout}, K={kernel_size}, '
                         f'dilation={dilation}, stages={stages})')


def _check_block_args(x, w1, b1, w2, b2, wd, bd, kernel_size,
                      tensors: bool = True):
    """Raises for a block whose arguments disagree; ``tensors`` checks
    each tensor too (off where the launcher checks what it reads)."""
    b, t, cin = x.shape
    cout = w1.shape[-1]
    if (wd is None) != (bd is None):
        raise ValueError('wd and bd are given together or not at all')
    if wd is None and cin != cout:
        raise ValueError(f'Cin {cin} != Cout {cout} needs a downsample')
    if tensors:
        checks = [('x', x, (b, t, cin)),
                  ('w1', w1, (kernel_size, cin, cout)), ('b1', b1, (cout,)),
                  ('w2', w2, (kernel_size, cout, cout)), ('b2', b2, (cout,))]
        if wd is not None:
            checks += [('wd', wd, (cin, cout)), ('bd', bd, (cout,))]
        for name, arr, shape in checks:
            build.check_tensor(name, arr, shape, x.device)
    return b, t, cin, cout


def fused_temporal_block(x: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor,
                         b2: torch.Tensor,
                         wd: Optional[torch.Tensor] = None,
                         bd: Optional[torch.Tensor] = None, *,
                         kernel_size: int, dilation: int,
                         packed: Optional[tuple] = None) -> torch.Tensor:
    """x (B, T, Cin) float32; w1 (K, Cin, Cout); w2 (K, Cout, Cout);
    optional 1x1 downsample wd (Cin, Cout), bd (Cout).  Returns (B, T,
    Cout).  ``packed``: :func:`pack_block_weights` of the weights at
    ``dilation`` when the caller keeps it; derived here otherwise.  On the card the workspaces
    h and r (B, T, Cout) come from the caching allocator."""
    if x.device.type == 'cpu':
        return fused_temporal_block_ref(x, w1, b1, w2, b2, wd, bd,
                                        kernel_size=kernel_size,
                                        dilation=dilation)
    check_tf32x3_shape(x.shape[-1], w1.shape[-1], kernel_size, dilation)
    if x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x.device}')
    # launch_tf32x3 checks every tensor the kernel reads; w1, w2 and wd
    # only where they are packed here
    b, t, cin, cout = _check_block_args(x, w1, b1, w2, b2, wd, bd,
                                        kernel_size, tensors=packed is None)
    if packed is None:
        packed = pack_block_weights(w1, w2, wd, dilation=dilation)
    out = torch.empty((b, t, cout), device=x.device, dtype=torch.float32)
    if b == 0 or t == 0:
        return out
    launch_tf32x3(pad_channels(x), packed, b1, b2, bd, torch.empty_like(out),
                  None if wd is None else torch.empty_like(out), out,
                  kernel_size=kernel_size, dilation=dilation)
    fused_temporal_block.launches += 1
    return out


fused_temporal_block.launches = 0


def fused_temporal_block_simt(x: torch.Tensor, w1: torch.Tensor,
                              b1: torch.Tensor, w2: torch.Tensor,
                              b2: torch.Tensor,
                              wd: Optional[torch.Tensor] = None,
                              bd: Optional[torch.Tensor] = None, *,
                              kernel_size: int,
                              dilation: int) -> torch.Tensor:
    """The earlier one-launch kernel on the CUDA cores
    (``csrc/tcn_block.cu``), kept to be timed beside
    :func:`fused_temporal_block`'s: no model path calls it.  The arguments
    are :func:`fused_temporal_block`'s; Cout a power of two from 4 to 256.
    The plain version on the CPU; ``fused_temporal_block_simt.launches``
    counts its launches."""
    if x.device.type == 'cpu':
        return fused_temporal_block_ref(x, w1, b1, w2, b2, wd, bd,
                                        kernel_size=kernel_size,
                                        dilation=dilation)
    if x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x.device}')
    b, t, cin, cout = _check_block_args(x, w1, b1, w2, b2, wd, bd,
                                        kernel_size)
    if cout % 4 or cout > 256 or 256 % cout:
        raise ValueError(f'Cout {cout}: the kernel takes a power of two '
                         f'from 4 to 256')
    out = torch.empty((b, t, cout), device=x.device, dtype=torch.float32)
    if b == 0 or t == 0:
        return out
    lib = build.library()
    err = lib.fvt_tcn_block_forward(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), None if wd is None else wd.data_ptr(),
        None if bd is None else bd.data_ptr(), out.data_ptr(),
        b, t, cin, cout, kernel_size, dilation,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f'tcn_block SIMT kernel (B={b}, T={t}, Cin={cin}, '
                     f'Cout={cout}, K={kernel_size}, dilation={dilation})')
    fused_temporal_block_simt.launches += 1
    return out


fused_temporal_block_simt.launches = 0


def tcn_forward(x: torch.Tensor, blocks: Sequence[dict], kernel_size: int,
                *, reference: bool = False,
                after: Optional[Callable[[int, torch.Tensor], torch.Tensor]]
                = None) -> torch.Tensor:
    """A whole TemporalConvNet in eval mode, as ``tcn_forward_pallas``:
    block ``i`` has dilation ``2**i``.  ``blocks`` holds per block the
    materialised kernel weights ``w1, b1, w2, b2`` and ``wd, bd`` (None
    without a downsample), and optionally ``packed``
    (:func:`pack_block_weights`).  ``reference=True`` runs the plain
    version.  ``after(i, x)``, where given, runs on block ``i``'s output
    before block ``i + 1`` (the TCN's ``attention=1``)."""
    for i, blk in enumerate(blocks):
        args = (x, blk['w1'], blk['b1'], blk['w2'], blk['b2'], blk['wd'],
                blk['bd'])
        kw = dict(kernel_size=kernel_size, dilation=2 ** i)
        x = (fused_temporal_block_ref(*args, **kw) if reference else
             fused_temporal_block(*args, **kw, packed=blk.get('packed')))
        if after is not None:
            x = after(i, x)
    return x


# ------------------------------------------------------------ train path
def fused_temporal_block_train_ref(x, w1, b1, w2, b2, m1, m2, res, *,
                                   kernel_size: int,
                                   dilation: int) -> torch.Tensor:
    """Plain, differentiable PyTorch version of the train-mode block:
    ``leaky(leaky(conv2(leaky(conv1 x + b1) * m1) + b2) * m2 + res)``."""
    if w1.shape[0] != kernel_size or w2.shape[0] != kernel_size:
        raise ValueError(f'kernel_size {kernel_size} != weight taps '
                         f'{w1.shape[0]}, {w2.shape[0]}')
    h = _leaky(_causal_conv(x, w1, b1, dilation)) * m1
    net = _leaky(_causal_conv(h, w2, b2, dilation)) * m2
    return _leaky(net + res)


def _shift_back(v: torch.Tensor, n: int) -> torch.Tensor:
    """out[:, s] = v[:, s + n], zero where s + n runs past the end."""
    if n == 0:
        return v
    return F.pad(v[:, n:], (0, 0, 0, min(n, v.shape[1])))


def _shift_forward(v: torch.Tensor, n: int) -> torch.Tensor:
    """out[:, t] = v[:, t - n], zero where t < n (the causal pad)."""
    if n == 0:
        return v
    t = v.shape[1]
    return F.pad(v[:, :max(t - n, 0)], (0, 0, min(n, t), 0))


def _block_bwd_ref(x, w1, w2, m1, m2, res, a1, a2, g, *, dilation: int
                   ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' arithmetic in plain PyTorch, in the gather
    form of ``csrc/tcn_block_train.cu``: from the forward's saved
    pre-activations ``a1 = conv1 x + b1`` and ``a2 = conv2 h + b2`` and the
    cotangent ``g`` of the output, returns
    ``(dx, dw1, db1, dw2, db2, dres)``."""
    k = w1.shape[0]
    pad = (k - 1) * dilation
    h = _leaky(a1) * m1
    gz = g * _dleaky(_leaky(a2) * m2 + res)
    d_a2 = gz * m2 * _dleaky(a2)
    # d_h[s] = sum_k d_a2[s + pad - k*d] . w2[k]^T, zero beyond T - 1
    d_h = sum(_shift_back(d_a2, pad - i * dilation) @ w2[i].t()
              for i in range(k))
    d_a1 = d_h * m1 * _dleaky(a1)
    dx = sum(_shift_back(d_a1, pad - i * dilation) @ w1[i].t()
             for i in range(k))
    # dw[k] = sum_{b,t} in[t - pad + k*d]^T d_a[t], in = 0 before time 0
    dw2 = torch.stack([torch.einsum(
        'btc,bto->co', _shift_forward(h, pad - i * dilation), d_a2)
        for i in range(k)])
    dw1 = torch.stack([torch.einsum(
        'btc,bto->co', _shift_forward(x, pad - i * dilation), d_a1)
        for i in range(k)])
    return dx, dw1, d_a1.sum((0, 1)), dw2, d_a2.sum((0, 1)), gz


def _wgrad_shares(batch: int, taps: int, ca: int, cd: int,
                  sm_count: int) -> int:
    """Batch shares of a weight gradient: its (tap, 64 x 64) tiles alone
    fill the card where there are two for every SM; else the batch is cut
    so that about that many blocks run."""
    tiles = taps * -(-ca // 64) * -(-cd // 64)
    return max(1, min(batch, -(-2 * sm_count // tiles)))


def pad_train_inputs(x: torch.Tensor, w1: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x, w1)`` as the train kernels take them: x with zero channels up
    to a multiple of 4 (:func:`pad_channels`) and w1 (K, Cin, Cout) with
    zero rows on its Cin axis to match, so the forward's sums are the
    unpadded block's; both themselves where Cin is a multiple of 4."""
    xp = pad_channels(x)
    extra = xp.shape[-1] - x.shape[-1]
    return xp, w1 if not extra else F.pad(w1, (0, 0, 0, extra))


def slice_train_grads(cin: int, dx: torch.Tensor, dw1: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of x and w1 of the block on :func:`pad_train_inputs`'
    tensors, cut back to the ``cin`` channels of the unpadded ones."""
    return dx[..., :cin], dw1[:, :cin]


def _check_train_args(x, w1, b1, w2, b2, m1, m2, res, kernel_size):
    b, t, cin = x.shape
    cout = w1.shape[-1]
    if cin % 4 or cout % 4:
        raise ValueError(f'Cin {cin}, Cout {cout}: the kernels take '
                         f'multiples of 4 (pad_train_inputs pads Cin)')
    for name, arr, shape in [
            ('x', x, (b, t, cin)), ('w1', w1, (kernel_size, cin, cout)),
            ('b1', b1, (cout,)), ('w2', w2, (kernel_size, cout, cout)),
            ('b2', b2, (cout,)), ('m1', m1, (b, t, cout)),
            ('m2', m2, (b, t, cout)), ('res', res, (b, t, cout))]:
        build.check_tensor(name, arr, shape, x.device)
    return b, t, cin, cout


class _FusedTemporalBlockTrainSimt(torch.autograd.Function):
    """Forward and backward through ``csrc/tcn_block_train.cu``, the
    CUDA-core kernels (:func:`fused_temporal_block_train_simt`).  The
    forward keeps the pre-activations a1 and a2, so the backward
    recomputes no convolution.  A Cin that is no multiple of 4 (mfcc's 39)
    runs on zero channels (:func:`pad_train_inputs`), and the backward
    cuts dx and dw1 back (:func:`slice_train_grads`)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, m1, m2, res, kernel_size, dilation):
        ctx.cin = x.shape[-1]
        x, w1 = pad_train_inputs(x, w1)
        b, t, cin, cout = _check_train_args(x, w1, b1, w2, b2, m1, m2, res,
                                            kernel_size)
        a1 = torch.empty((b, t, cout), device=x.device, dtype=torch.float32)
        a2 = torch.empty_like(a1)
        out = torch.empty_like(a1)
        ctx.kernel_size, ctx.dilation = kernel_size, dilation
        ctx.save_for_backward(x, w1, w2, m1, m2, res, a1, a2)
        if b * t == 0:
            return out
        err = build.library().fvt_tcn_block_train_forward(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), m1.data_ptr(), m2.data_ptr(), res.data_ptr(),
            a1.data_ptr(), a2.data_ptr(), out.data_ptr(), b, t, cin, cout,
            kernel_size, dilation,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, f'tcn_block_train forward (B={b}, T={t}, '
                         f'Cin={cin}, Cout={cout}, K={kernel_size}, '
                         f'dilation={dilation})')
        fused_temporal_block_train_simt.launches_fwd += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, m1, m2, res, a1, a2 = ctx.saved_tensors
        k, dil = ctx.kernel_size, ctx.dilation
        b, t, cin = x.shape
        cout = w1.shape[-1]
        g = g.contiguous()
        build.check_tensor('g', g, (b, t, cout), x.device)
        dev = x.device

        def empty(*shape):
            return torch.empty(shape, device=dev, dtype=torch.float32)

        dx, dres = empty(b, t, cin), empty(b, t, cout)
        dw1, dw2 = empty(k, cin, cout), empty(k, cout, cout)
        db1, db2 = empty(cout), empty(cout)
        if b * t == 0:
            dx, dw1 = slice_train_grads(ctx.cin, dx, dw1.zero_())
            return (dx, dw1, db1.zero_(), dw2.zero_(), db2.zero_(),
                    None, None, dres, None, None)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        s1 = _wgrad_shares(b, k, cin, cout, sms)
        s2 = _wgrad_shares(b, k, cout, cout, sms)
        d_a2, d_a1 = empty(b, t, cout), empty(b, t, cout)
        part1 = empty(s1, k, cin, cout) if s1 > 1 else None
        part2 = empty(s2, k, cout, cout) if s2 > 1 else None
        err = build.library().fvt_tcn_block_train_backward(
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), m1.data_ptr(),
            m2.data_ptr(), res.data_ptr(), a1.data_ptr(), a2.data_ptr(),
            g.data_ptr(), d_a2.data_ptr(), d_a1.data_ptr(),
            None if part1 is None else part1.data_ptr(),
            None if part2 is None else part2.data_ptr(),
            dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            db2.data_ptr(), dres.data_ptr(), b, t, cin, cout, k, dil, s1, s2,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, f'tcn_block_train backward (B={b}, T={t}, '
                         f'Cin={cin}, Cout={cout}, K={k}, dilation={dil})')
        fused_temporal_block_train_simt.launches_bwd += 1
        dx, dw1 = slice_train_grads(ctx.cin, dx, dw1)
        return dx, dw1, db1, dw2, db2, None, None, dres, None, None


# the split-TF32 train kernels (csrc/tcn_block_train_tf32x3.cu): frames a
# slice of the weight-gradient kernel, and the launches of each C entry,
# a bit each
WGRAD_ROWS = 32
PACK, TRAIN_CONV1, TRAIN_CONV2 = 1, 2, 4
TRAIN_FORWARD = PACK | TRAIN_CONV1 | TRAIN_CONV2
OUT_GRAD, PACK_T, D_A1, DX, DW2, DW1, BIAS_GRADS = 1, 2, 4, 8, 16, 32, 64
TRAIN_BACKWARD = 127


def transpose_taps(w: torch.Tensor) -> torch.Tensor:
    """w (K, C, Co) as the weights of its anti-causal transpose, (K, Co,
    C) with tap k = ``w[K-1-k]^T``: the conv of the input gradient
    ``d_in[s] = sum_k d_out[s + (K-1)*d - k*d] . w[k]^T`` with tap k
    reading frame ``s + k*d``."""
    return w.flip(0).transpose(1, 2)


def _split_wgrad(act: torch.Tensor, d: torch.Tensor, kernel_size: int,
                 dilation: int, shares: int) -> torch.Tensor:
    """``dw[k] = sum_{b,t} act[t - (K-1-k)*d]^T d[t]`` (act zero before
    frame 0) as the weight-gradient kernel sums it: per tap and batch
    share (rows ``B*s//S`` up to ``B*(s+1)//S``), row by row, slices of
    ``WGRAD_ROWS`` frames from the first one whose act frames are not all
    in the pad, each slice's ``(act_hi * d_lo + act_lo * d_hi) + act_hi *
    d_hi`` of the parts of ``ops.conv.split_tf32`` in float32 added to the
    share's sum from 0; then the shares added in order."""
    b, t, _ = act.shape
    pad = (kernel_size - 1) * dilation
    ah, al = split_tf32(act)
    dh, dl = split_tf32(d)
    taps = []
    for k in range(kernel_size):
        shift = pad - k * dilation
        sh, sl = _shift_forward(ah, shift), _shift_forward(al, shift)
        total = None
        for s in range(shares):
            part = act.new_zeros(act.shape[-1], d.shape[-1])
            for row in range(b * s // shares, b * (s + 1) // shares):
                for t0 in range(shift // WGRAD_ROWS * WGRAD_ROWS, t,
                                WGRAD_ROWS):
                    f = slice(t0, t0 + WGRAD_ROWS)

                    def prod(p, q):
                        return p[row, f].t() @ q[row, f]

                    part = part + ((prod(sh, dl) + prod(sl, dh))
                                   + prod(sh, dh))
            total = part if total is None else total + part
        taps.append(total)
    return torch.stack(taps)


def train_forward_tf32x3_ref(x, w1, b1, w2, b2, m1, m2, res, *,
                             kernel_size: int, dilation: int) -> tuple:
    """What the split-TF32 train kernel's forward computes, emulated on
    float32 tensors: ``(a1, h, a2, out)`` with both convs as
    :func:`_split_conv` (h split again where conv2 stages it), leaky, the
    masks and the residual as :func:`fused_temporal_block_train_ref`.  The
    kernel's sums run in another order (per 8-channel slice, then over
    the slices)."""
    if w1.shape[0] != kernel_size or w2.shape[0] != kernel_size:
        raise ValueError(f'kernel_size {kernel_size} != weight taps '
                         f'{w1.shape[0]}, {w2.shape[0]}')
    a1 = _split_conv(x, w1, b1, dilation)
    h = _leaky(a1) * m1
    a2 = _split_conv(h, w2, b2, dilation)
    return a1, h, a2, _leaky(_leaky(a2) * m2 + res)


def fused_temporal_block_train_tf32x3_ref(x, w1, b1, w2, b2, m1, m2, res,
                                          *, kernel_size: int,
                                          dilation: int) -> torch.Tensor:
    """The split-TF32 train forward's output, emulated
    (:func:`train_forward_tf32x3_ref`)."""
    return train_forward_tf32x3_ref(x, w1, b1, w2, b2, m1, m2, res,
                                    kernel_size=kernel_size,
                                    dilation=dilation)[-1]


def _block_bwd_tf32x3_ref(x, w1, w2, m1, m2, res, a1, h, a2, g, *,
                          dilation: int, shares: Tuple[int, int] = (1, 1),
                          need_dx: bool = True) -> Tuple:
    """What the split-TF32 backward computes, emulated on float32 tensors
    from the forward's saved a1, h and a2: ``(dx, dw1, db1, dw2, db2,
    dres)`` as :func:`_block_bwd_ref`, with d_h and dx the anti-causal
    :func:`_split_conv` on :func:`transpose_taps` of w2 and w1, the weight
    gradients :func:`_split_wgrad` in ``shares = (S1, S2)`` batch shares,
    the bias gradients float32 column sums; dx None unless ``need_dx``."""
    k = w1.shape[0]
    gz = g * _dleaky(_leaky(a2) * m2 + res)
    d_a2 = gz * m2 * _dleaky(a2)
    d_h = _split_conv(d_a2, transpose_taps(w2), None, dilation,
                      causal=False)
    d_a1 = d_h * m1 * _dleaky(a1)
    dx = (_split_conv(d_a1, transpose_taps(w1), None, dilation, causal=False)
          if need_dx else None)
    dw2 = _split_wgrad(h, d_a2, k, dilation, shares[1])
    dw1 = _split_wgrad(x, d_a1, k, dilation, shares[0])
    return dx, dw1, d_a1.sum((0, 1)), dw2, d_a2.sum((0, 1)), gz


def train_pack_shape(cin: int, cout: int, kernel_size: int,
                     dilation: int) -> tuple:
    """Shape of one part of a train conv's packed weights, the conv taking
    ``cin`` inputs to ``cout`` outputs: (tiles, slices, G * groups, 2, 8,
    8, 4) as ``ops.conv.pack_taps_tf32`` lays them out at column tiles of
    ``COLUMN_TILE``, the taps as :func:`pad_taps` gives them."""
    g, groups = tap_groups(kernel_size, dilation)
    return (-(-cout // COLUMN_TILE), -(-cin // 8), g * groups, 2,
            COLUMN_TILE // 8, 8, 4)


def pack_train_weights(w1: torch.Tensor, w2: torch.Tensor, *,
                       dilation: int, transposed: bool = False) -> tuple:
    """``((w1_hi, w1_lo), (w2_hi, w2_lo))`` as the train kernel's pack
    launch writes them into its workspace each call: w1 (K, Cin, Cout) and
    w2 (K, Cout, Cout) split and packed by ``ops.conv.pack_taps_tf32`` at
    column tiles of ``COLUMN_TILE``, the taps as :func:`pad_taps` gives
    them at ``dilation``; ``transposed``: :func:`transpose_taps` of each,
    for the backward's anti-causal convs.  Each part's shape is
    :func:`train_pack_shape` of its conv."""
    if transposed:
        w1, w2 = transpose_taps(w1), transpose_taps(w2)
    return (pack_taps_tf32(pad_taps(w1, dilation), COLUMN_TILE),
            pack_taps_tf32(pad_taps(w2, dilation), COLUMN_TILE))


@functools.lru_cache(maxsize=256)
def train_scratch(b: int, t: int, cin: int, cout: int, kernel_size: int,
                  dilation: int, *, backward: bool = False,
                  shares: Tuple[int, int] = (1, 1)) -> tuple:
    """``(layout, floats)``: where the train kernels' scratch lies in one
    float32 allocation of ``floats``, ``layout[name] = (offset, shape)`` in
    floats, each part 16-byte aligned.  The forward's: the packed weights
    ``w1_hi, w1_lo, w2_hi, w2_lo`` (:func:`pack_train_weights`).  The
    backward's: ``d_a2, d_a1`` (B, T, Cout), the transposed packed weights
    under the same names, and the weight gradients' batch shares ``part1``
    (S1, K, Cin, Cout) and ``part2`` (S2, K, Cout, Cout) where ``shares``
    holds more than one."""
    k = kernel_size
    parts = []
    if backward:
        parts += [('d_a2', (b, t, cout)), ('d_a1', (b, t, cout))]
        w1 = train_pack_shape(cout, cin, k, dilation)
    else:
        w1 = train_pack_shape(cin, cout, k, dilation)
    w2 = train_pack_shape(cout, cout, k, dilation)
    parts += [('w1_hi', w1), ('w1_lo', w1), ('w2_hi', w2), ('w2_lo', w2)]
    if backward:
        s1, s2 = shares
        parts += [('part1', (s1, k, cin, cout))] if s1 > 1 else []
        parts += [('part2', (s2, k, cout, cout))] if s2 > 1 else []
    layout, floats = {}, 0
    for name, shape in parts:
        layout[name] = (floats, shape)
        floats += -(-math.prod(shape) // 4) * 4
    # read-only: the cache hands the same layout to every caller
    return types.MappingProxyType(layout), floats


def _pointers(scratch: torch.Tensor, layout: dict, *names) -> list:
    base = scratch.data_ptr()
    return [base + 4 * layout[n][0] if n in layout else None for n in names]


def launch_train_tf32x3_forward(x, w1, b1, w2, b2, m1, m2, res, scratch,
                                saved, out, *, kernel_size: int,
                                dilation: int, stages: int = TRAIN_FORWARD,
                                check: bool = True) -> None:
    """Launches the ``stages`` of the split-TF32 train forward on the
    current stream: the pack (w1, w2 -> the packed parts of ``scratch``,
    :func:`train_scratch`), conv1 (x -> a1, h), conv2 (h -> a2, out), with
    ``saved`` (3, B, T, Cout) holding a1, h and a2.  x and w1 as
    :func:`pad_train_inputs` returns them.  ``check``: checks every
    tensor (off where the caller has checked its inputs and allocated the
    rest); raises on a CUDA error; counts nothing (a measurement may
    launch one stage alone)."""
    b, t, cin = x.shape
    cout = w1.shape[-1]
    layout, floats = train_scratch(b, t, cin, cout, kernel_size, dilation)
    if check:
        _check_train_args(x, w1, b1, w2, b2, m1, m2, res, kernel_size)
        for name, arr, shape in (('scratch', scratch, (floats,)),
                                 ('saved', saved, (3, b, t, cout)),
                                 ('out', out, (b, t, cout))):
            build.check_tensor(name, arr, shape, x.device)
    a = saved.data_ptr()
    n = 4 * b * t * cout
    err = build.library().fvt_tcn_block_train_tf32x3_forward(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), m1.data_ptr(), m2.data_ptr(), res.data_ptr(),
        *_pointers(scratch, layout, 'w1_hi', 'w1_lo', 'w2_hi', 'w2_lo'),
        a, a + n, a + 2 * n, out.data_ptr(), b, t, cin, cout, kernel_size,
        dilation, stages, torch.cuda.current_stream(x.device).cuda_stream)
    if err:  # the message is built only for an error
        build.check(err, f'tcn_block_train split-TF32 forward (B={b}, T={t}, '
                         f'Cin={cin}, Cout={cout}, K={kernel_size}, '
                         f'dilation={dilation}, stages={stages})')


def train_shares(x: torch.Tensor, cout: int, kernel_size: int
                 ) -> Tuple[int, int]:
    """``(S1, S2)``: the batch shares of dw1 and dw2 on x's card
    (:func:`_wgrad_shares`)."""
    b, _, cin = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return (_wgrad_shares(b, kernel_size, cin, cout, sms),
            _wgrad_shares(b, kernel_size, cout, cout, sms))


def launch_train_tf32x3_backward(inputs: tuple, saved, g, scratch,
                                 grads: tuple, *, kernel_size: int,
                                 dilation: int, shares: Tuple[int, int],
                                 stages: int = TRAIN_BACKWARD,
                                 check: bool = True, entry=None) -> None:
    """Launches the ``stages`` of the split-TF32 train backward on the
    current stream.  ``inputs``: the forward's ``(x, w1, w2, m1, m2,
    res)`` (x and w1 padded); ``saved``: its (3, B, T, Cout) a1, h, a2;
    ``scratch`` as :func:`train_scratch` lays it out for the backward at
    ``shares``; ``grads``: ``(dx, dw1, db1, dw2, db2, dres)``, dx None to
    skip its launch.  ``check``: checks every tensor (off where the
    caller has); ``entry``: the C entry of another build of the source
    (``tools/profile_train.py --diag``); raises on a CUDA error; counts
    nothing."""
    x, w1, w2, m1, m2, res = inputs
    dx, dw1, db1, dw2, db2, dres = grads
    b, t, cin = x.shape
    cout = w1.shape[-1]
    k = kernel_size
    layout, floats = train_scratch(b, t, cin, cout, k, dilation,
                                   backward=True, shares=shares)
    if check:
        dev = x.device
        checks = [('x', x, (b, t, cin)), ('w1', w1, (k, cin, cout)),
                  ('w2', w2, (k, cout, cout)), ('saved', saved,
                                                (3, b, t, cout)),
                  ('scratch', scratch, (floats,)),
                  ('dw1', dw1, (k, cin, cout)), ('dw2', dw2, (k, cout, cout)),
                  ('db1', db1, (cout,)), ('db2', db2, (cout,))]
        checks += [(n, v, (b, t, cout)) for n, v in (
            ('m1', m1), ('m2', m2), ('res', res), ('g', g), ('dres', dres))]
        if dx is not None:
            checks.append(('dx', dx, (b, t, cin)))
        for name, arr, shape in checks:
            build.check_tensor(name, arr, shape, dev)
        if cin % 4 or cout % 4:
            raise ValueError(f'Cin {cin}, Cout {cout}: the kernels take '
                             f'multiples of 4 (pad_train_inputs pads Cin)')
    a = saved.data_ptr()
    n = 4 * b * t * cout
    args = (x.data_ptr(), w1.data_ptr(), w2.data_ptr(), m1.data_ptr(),
            m2.data_ptr(), res.data_ptr(), a, a + n, a + 2 * n, g.data_ptr(),
            *_pointers(scratch, layout, 'd_a2', 'd_a1', 'w1_hi', 'w1_lo',
                       'w2_hi', 'w2_lo', 'part1', 'part2'),
            None if dx is None else dx.data_ptr(), dw1.data_ptr(),
            db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), dres.data_ptr(),
            b, t, cin, cout, k, dilation, *shares, stages,
            torch.cuda.current_stream(x.device).cuda_stream)
    err = (entry or build.library().fvt_tcn_block_train_tf32x3_backward)(
        *args)
    if err:
        build.check(err, f'tcn_block_train split-TF32 backward (B={b}, '
                         f'T={t}, Cin={cin}, Cout={cout}, K={k}, '
                         f'dilation={dilation}, stages={stages})')


def train_forward(x, w1, b1, w2, b2, m1, m2, res, *, kernel_size: int,
                  dilation: int) -> tuple:
    """``(saved, out)`` of the train block on x and w1 as
    :func:`pad_train_inputs` returns them, ``saved`` (3, B, T, Cout)
    holding a1, h = leaky(a1) * m1 and a2: the plain version for tensors
    on the CPU, the split-TF32 kernel's three launches on the card
    (counted in ``fused_temporal_block_train.launches_fwd``)."""
    if x.device.type == 'cpu':
        a1 = _causal_conv(x, w1, b1, dilation)
        h = _leaky(a1) * m1
        a2 = _causal_conv(h, w2, b2, dilation)
        return torch.stack([a1, h, a2]), _leaky(_leaky(a2) * m2 + res)
    b, t, cin, cout = _check_train_args(x, w1, b1, w2, b2, m1, m2, res,
                                        kernel_size)
    saved = torch.empty((3, b, t, cout), device=x.device)
    out = torch.empty((b, t, cout), device=x.device)
    if b * t:
        floats = train_scratch(b, t, cin, cout, kernel_size, dilation)[1]
        launch_train_tf32x3_forward(
            x, w1, b1, w2, b2, m1, m2, res,
            torch.empty(floats, device=x.device), saved, out,
            kernel_size=kernel_size, dilation=dilation, check=False)
        fused_temporal_block_train.launches_fwd += 1
    return saved, out


def train_backward(inputs: tuple, saved: torch.Tensor, g: torch.Tensor, *,
                   kernel_size: int, dilation: int,
                   need_dx: bool = True) -> tuple:
    """``(dx, dw1, db1, dw2, db2, dres)`` of the train block for the
    cotangent g of its output, from :func:`train_forward`'s ``inputs = (x,
    w1, w2, m1, m2, res)`` and ``saved``; dx None unless ``need_dx`` (the
    kernel then skips its launch).  The plain formula
    (:func:`_block_bwd_ref`) for tensors on the CPU, the split-TF32
    kernel's launches on the card (counted in
    ``fused_temporal_block_train.launches_bwd``)."""
    x, w1, w2, m1, m2, res = inputs
    k = kernel_size
    if x.device.type == 'cpu':
        grads = _block_bwd_ref(x, w1, w2, m1, m2, res, saved[0], saved[2],
                               g, dilation=dilation)
        return (grads[0] if need_dx else None,) + grads[1:]
    b, t, cin = x.shape
    cout = w1.shape[-1]
    dev = x.device
    build.check_tensor('g', g, (b, t, cout), dev)

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    grads = (empty(b, t, cin) if need_dx else None, empty(k, cin, cout),
             empty(cout), empty(k, cout, cout), empty(cout), empty(b, t, cout))
    if b * t == 0:
        for v in grads[1:5]:
            v.zero_()
        return grads
    shares = train_shares(x, cout, k)
    floats = train_scratch(b, t, cin, cout, k, dilation, backward=True,
                           shares=shares)[1]
    launch_train_tf32x3_backward(
        inputs, saved, g, torch.empty(floats, device=dev), grads,
        kernel_size=k, dilation=dilation, shares=shares, check=False)
    fused_temporal_block_train.launches_bwd += 1
    return grads


class _FusedTemporalBlockTrain(torch.autograd.Function):
    """Forward and backward through ``csrc/tcn_block_train_tf32x3.cu``
    (:func:`train_forward`, :func:`train_backward`).  The forward keeps
    the pre-activations a1 and a2 and h = leaky(a1) * m1, so the backward
    recomputes no convolution; where x needs no gradient (a TCN's first
    block, on the features) the backward skips dx.  A Cin that is no
    multiple of 4 (mfcc's 39) runs on zero channels
    (:func:`pad_train_inputs`), and the backward cuts dx and dw1 back."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, m1, m2, res, kernel_size, dilation):
        ctx.cin = x.shape[-1]
        x, w1 = pad_train_inputs(x, w1)
        saved, out = train_forward(x, w1, b1, w2, b2, m1, m2, res,
                                   kernel_size=kernel_size,
                                   dilation=dilation)
        ctx.kernel_size, ctx.dilation = kernel_size, dilation
        ctx.save_for_backward(x, w1, w2, m1, m2, res, saved)
        return out

    @staticmethod
    def backward(ctx, g):
        *inputs, saved = ctx.saved_tensors
        dx, dw1, db1, dw2, db2, dres = train_backward(
            tuple(inputs), saved, g.contiguous(),
            kernel_size=ctx.kernel_size, dilation=ctx.dilation,
            need_dx=ctx.needs_input_grad[0])
        if dx is not None:
            dx = dx[..., :ctx.cin]
        return (dx, dw1[:, :ctx.cin], db1, dw2, db2, None, None, dres, None,
                None)


def fused_temporal_block_train(x, w1, b1, w2, b2, m1, m2, res, *,
                               kernel_size: int,
                               dilation: int) -> torch.Tensor:
    """Differentiable fused block: x (B, T, Cin), any Cin; w1 (K, Cin,
    Cout), Cout a multiple of 4 on the card; w2
    (K, Cout, Cout); masks m1, m2 (B, T, Cout) pre-scaled to
    {0, 1/(1-p)} (ones without dropout); res (B, T, Cout) the residual
    stream (x itself, or its 1x1 downsample).  Gradients flow to x, the
    weights, the biases and res, not to the masks.  For float32 CUDA
    tensors the split-TF32 kernels (:class:`_FusedTemporalBlockTrain`),
    for CPU tensors :func:`fused_temporal_block_train_ref` under ordinary
    autograd."""
    if x.device.type == 'cpu':
        return fused_temporal_block_train_ref(
            x, w1, b1, w2, b2, m1, m2, res, kernel_size=kernel_size,
            dilation=dilation)
    if x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x.device}')
    return _FusedTemporalBlockTrain.apply(x, w1, b1, w2, b2, m1, m2, res,
                                          kernel_size, dilation)


fused_temporal_block_train.launches_fwd = 0
fused_temporal_block_train.launches_bwd = 0


def fused_temporal_block_train_simt(x, w1, b1, w2, b2, m1, m2, res, *,
                                    kernel_size: int,
                                    dilation: int) -> torch.Tensor:
    """The earlier train kernels on the CUDA cores
    (``csrc/tcn_block_train.cu``, :class:`_FusedTemporalBlockTrainSimt`),
    kept to be timed beside :func:`fused_temporal_block_train`'s: no
    model path calls it.  The arguments are
    :func:`fused_temporal_block_train`'s; the plain version on the CPU;
    ``.launches_fwd`` and ``.launches_bwd`` count its C entries' calls."""
    if x.device.type == 'cpu':
        return fused_temporal_block_train_ref(
            x, w1, b1, w2, b2, m1, m2, res, kernel_size=kernel_size,
            dilation=dilation)
    if x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x.device}')
    return _FusedTemporalBlockTrainSimt.apply(x, w1, b1, w2, b2, m1, m2,
                                              res, kernel_size, dilation)


fused_temporal_block_train_simt.launches_fwd = 0
fused_temporal_block_train_simt.launches_bwd = 0
