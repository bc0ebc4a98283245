"""The host side of the bfloat16 block kernel
(``csrc/bottleneck_bf16_wgmma.cu``, ``ops.bottleneck.launch_bf16``) on the
CPU, where no CUDA kernel runs: its plan, and what it reads and writes and
where, emulated in plain numpy and held bit for bit against the block's
plain version.

* ``bf16_block_plan`` (the C entry's plan, mirrored): the column tile, the
  staged coordinates, the ring's slots and the shared memory under 227 KB
  at the IR-50's four stage shapes (N = 2400) and ``chip_smoke.py``'s six
  bfloat16 edge shapes; the refusals (C not a multiple of 16, frames wider
  than 126, and 126 at C = 512, where three slots leave the shared
  memory).
* The kernel's addressing emulated (:func:`emulate`): each slice staged
  from the padded line (zeros past the last frame), bn1 written by the
  consumer threads' own rows, each row once, bf16(a1*x + b1)
  where ``pixel_bits`` finds an image pixel and 0 elsewhere, bit for bit
  ``bn1_line``; the nine taps as row offsets into the patch times the
  packed weights (``pack_block_weights_bf16``); the epilogue in the
  accumulator's layout on the staged rows under the 128-byte swizzle, the
  residual rows as the copy engine lands them (x at each output
  coordinate, checked against x), PReLU or bn2 + x; the stores (16 bytes
  a lane, each row's pixel from the tile's start) writing every pixel and
  channel once.  On inputs whose every sum is exact in float32 (small
  integers, exact affines) the order of the sums cannot matter, so v and
  y equal ``bottleneck_bf16_conv1_ref`` / ``_conv2_ref`` bit for bit, at
  shapes with frames crossing row tiles, a partial last tile, two column
  tiles and channels past C in the last one.
"""
import numpy as np
import pytest
import torch

from fvt_tpu_torch.ops import bottleneck as block_ops

BF16 = torch.bfloat16
# (N, H, W, C): the IR-50's identity blocks on 2400 frames, then
# chip_smoke.py's bfloat16 edge shapes
STAGES = [(2400, 40, 40, 64), (2400, 20, 20, 128), (2400, 10, 10, 256),
          (2400, 5, 5, 512)]
EDGES = [(3, 7, 9, 32), (1, 1, 1, 16), (5, 10, 10, 64), (2, 13, 6, 16),
         (7, 5, 5, 512), (3, 9, 11, 256)]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('n,h,w,c', STAGES + EDGES)
def test_bf16_block_plan(n, h, w, c):
    plan = block_ops.bf16_block_plan(n, h, w, c)
    bn = 64 if c <= 64 else 128
    assert (plan['bn'], plan['slots']) == (bn, 4 if bn == 64 else 3)
    staged = 256 + 2 * (w + 1) + 2
    assert plan['p'] >= staged > plan['p'] - 128 and plan['p'] % 128 == 0
    assert plan['p'] == 384  # every shape here: W <= 62
    assert plan['loads'] == 3
    assert plan['q'] == n * (h + 1) * (w + 1)
    assert plan['rows'] == plan['q'] - (w + 2)
    assert plan['n_tiles'] == -(-c // bn)
    assert plan['tiles'] == -(-plan['rows'] // 256) * plan['n_tiles']
    t = plan['n_tiles'] * bn
    assert plan['vec_floats'] == 2 * c + 2 * t
    # barriers and alignment, the staged rows, the ring (two 8-channel
    # chunks of p coordinates and nine taps' weights a slot), the vectors
    smem = (256 + 1024 + 256 * bn * 2
            + plan['slots'] * (2 * plan['p'] * 16 + 9 * 16 * bn * 2)
            + 4 * plan['vec_floats'])
    assert plan['smem_bytes'] == smem <= 227 * 1024
    if (h, c) == (10, 256) and n == 2400:  # 13 of the 21 blocks
        assert plan['tiles'] == 1135 * 2


def test_bf16_block_plan_widths_and_refusals():
    # the widest frame: 512 staged coordinates; at C = 512 three slots
    # leave the shared memory
    for c in (16, 64, 128, 256):
        assert block_ops.bf16_block_plan(2, 3, 126, c)['p'] == 512
    for n, h, w, c in ((2, 5, 5, 20), (2, 5, 5, 24), (1, 2, 127, 64),
                       (1, 2, 1200, 16), (1, 2, 126, 512), (0, 5, 5, 16)):
        with pytest.raises(ValueError):
            block_ops.bf16_block_plan(n, h, w, c)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _f32(a):
    return np.asarray(a, np.float32)


def _line(t):
    """The padded line of t (N, H, W, C): pixel (f, i, j) at f*(H+1)*(W+1)
    + (i+1)*(W+1) + j+1, zeros elsewhere; (Q, C)."""
    n, h, w, c = t.shape
    line = np.zeros((n, h + 1, w + 1, c), np.float64)
    line[:, 1:, 1:] = t
    return line.reshape(-1, c)


def _pixel(q, qs, frame, w1):
    """The kernel's test: coordinate q is an image pixel."""
    rem = q % frame
    return (q < qs) & (rem // w1 != 0) & (rem % w1 != 0)


def _rewrite_rows(p):
    """The staged rows r = chunk*P + coordinate a slot's rewrite writes,
    by the consumers' mapping (warpgroup wg, thread t: coordinates
    (wg//2)*128 + t + 256k of chunk wg % 2, k < 2), those inside the
    patch."""
    wg, t, k = np.meshgrid(np.arange(4), np.arange(128), np.arange(2),
                           indexing='ij')
    c0 = (wg // 2) * 128 + t + 256 * k
    return ((wg % 2) * p + c0)[c0 < p]


def _conv(src, res, packed, vecs, plan, shape, stage, line_bn1):
    """One launch of the kernel emulated: ``src`` the staged tensor (x or
    v), ``res`` the residual (x, conv2), ``packed`` the conv's packed
    weights, ``vecs`` (a1, b1, alpha) or (a2, b2); returns (N*H*W, C)."""
    n, h, w, c = shape
    bn, p, qs = plan['bn'], plan['p'], plan['q']
    w1, frame = w + 1, (h + 1) * (w + 1)
    row_tiles = plan['tiles'] // plan['n_tiles']
    line = np.zeros(((row_tiles - 1) * 256 + p + 512, c))
    line[:qs] = _line(src)  # the copy engine's zero fill past Q
    res_line = np.zeros_like(line)
    if res is not None:
        res_line[:qs] = _line(res)
    out = np.full((n * h * w, c), np.nan)
    written = np.zeros((n * h * w, c), np.int64)
    rows = _rewrite_rows(p)
    assert np.array_equal(np.sort(rows), np.arange(2 * p))  # each once
    chunk, coord = rows // p, rows % p
    chunks = max(bn // 64, 1)
    # the consumers' thread layout: (wg, warp, lane, half, j)
    wg, warp, lane, half, j = np.meshgrid(
        np.arange(4), np.arange(4), np.arange(32), np.arange(2),
        np.arange(bn // 8), indexing='ij')
    acc_r = wg * 64 + warp * 16 + lane // 4 + 8 * half
    acc_c = 8 * j + 2 * (lane % 4)
    acc_unit = (j % 8) ^ (lane // 4)
    assert np.array_equal(acc_unit, (j % 8) ^ (acc_r % 8))
    # the stores: (wg, warp, lane, k), BN/8 pieces a row
    per = bn // 8
    fwg, fwarp, flane, fk = np.meshgrid(np.arange(4), np.arange(4),
                                        np.arange(32), np.arange(per // 2),
                                        indexing='ij')
    fr = flane // per + (32 // per) * fk
    fpiece = flane % per
    f_row = fwg * 64 + fwarp * 16 + fr
    for rt in range(row_tiles):
        q0 = rt * 256
        q_out = q0 + w1 + 1 + np.arange(256)
        rem = q_out % frame
        pix = np.where(_pixel(q_out, qs, frame, w1),
                       (q_out // frame * h + rem // w1 - 1) * w
                       + rem % w1 - 1, -1)
        for ct in range(plan['n_tiles']):
            n0 = ct * bn
            acc = np.zeros((256, bn))
            for s in range(c // 16):
                staged = line[q0:q0 + p, 16 * s:16 * s + 16].copy()
                if stage == 1:  # bn1 over the slot, row by row
                    a1, b1 = vecs[0], vecs[1]
                    ch = 16 * s + 8 * chunk[:, None] + np.arange(8)
                    x8 = staged[coord[:, None], ch - 16 * s]
                    val = _bf16(_f32(_f32(x8 * a1[ch]) + b1[ch]))
                    on = _pixel(q0 + coord, qs, frame, w1)
                    staged[coord[:, None], ch - 16 * s] = np.where(
                        on[:, None], val, 0.0)
                    want = line_bn1[q0:q0 + p, 16 * s:16 * s + 16]
                    assert np.array_equal(staged, want)
                for tap in range(9):
                    shift = (tap // 3) * w1 + tap % 3
                    b = packed[ct, s, tap].permute(0, 2, 1, 3).reshape(
                        16, bn).float().numpy()
                    acc += staged[shift:shift + 256] @ b
            # the staged rows: [chunk][row][16-byte unit ^ row % 8][8]
            buf = np.full((chunks, 256, 8, 8), np.nan)
            if stage == 2:  # the residual as the copy engine lands it
                for cc in range(chunks):
                    for hh in range(2):
                        start = q0 + w1 + 1 + hh * 128
                        if start >= qs:
                            continue  # a load left out
                        r = hh * 128 + np.arange(128)
                        vals = np.zeros((128, 64))
                        cols = n0 + 64 * cc + np.arange(64)
                        inside = cols < c
                        vals[:, inside] = res_line[start:start + 128,
                                                   cols[inside]]
                        for u in range(8):
                            buf[cc, r, u ^ (r % 8)] = vals[:, 8 * u:8 * u + 8]
                got = buf[j // 8, acc_r, acc_unit, 2 * (lane % 4)]
                at = pix[acc_r] >= 0
                col = n0 + acc_c
                real = at & (col < c)
                assert np.array_equal(
                    got[real], res.reshape(-1, c)[pix[acc_r][real],
                                                  col[real]])
            for e in range(2):
                a = acc[acc_r, acc_c + e]
                col = np.minimum(n0 + acc_c + e, len(vecs[0]) - 1)
                live = n0 + acc_c + e < c
                if stage == 1:
                    alpha = np.where(live, vecs[2][col], 0.0)
                    o = np.where(a > 0, _f32(a), _f32(_f32(alpha) * _f32(a)))
                else:
                    a2 = np.where(live, vecs[0][col], 0.0)
                    b2 = np.where(live, vecs[1][col], 0.0)
                    r = buf[j // 8, acc_r, acc_unit, 2 * (lane % 4) + e]
                    o = _f32(_f32(_f32(_f32(a) * a2) + b2) + r)
                buf[j // 8, acc_r, acc_unit, 2 * (lane % 4) + e] = _bf16(o)
            # the stores: each lane's piece of a row, to the row's pixel
            data = buf[fpiece // 8, f_row, (fpiece % 8) ^ (fr % 8)]
            v = pix[f_row]
            cols = n0 + 8 * fpiece
            keep = (v >= 0) & (cols < c)
            for e in range(8):
                out[v[keep], cols[keep] + e] = data[keep][:, e]
                np.add.at(written, (v[keep], cols[keep] + e), 1)
    assert (written == 1).all()  # every pixel and channel once
    return out.reshape(shape)


def emulate(x, w1, w2, a1, b1, alpha, a2, b2):
    """The block's two launches emulated (the module docstring): x (N, H,
    W, C) and the kernels bfloat16 tensors, the vectors float32 ones;
    returns (v, y) as float64 arrays of bfloat16 values."""
    shape = tuple(x.shape)
    plan = block_ops.bf16_block_plan(*shape)
    p1, p2 = block_ops.pack_block_weights_bf16(w1, w2)
    xf = x.float().numpy().astype(np.float64)
    vec = [t.numpy().astype(np.float64) for t in (a1, b1, alpha, a2, b2)]
    bn1 = block_ops.bn1_line(x.float(), a1, b1).to(BF16).double().numpy()
    v = _conv(xf, None, p1, vec[:3], plan, shape, 1, bn1)
    y = _conv(v, xf, p2, vec[3:], plan, shape, 2, None)
    return v, y


def _exact_block(n, h, w, c, seed):
    """Inputs whose every product and partial sum is exact in float32:
    x in {-2..2}, sparse kernels in {-1, 0, 1}, a1, a2 in {0.5, 1, 2}, b1,
    b2 in {-1, -0.5, 0, 0.5, 1}, alpha 0.25."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-2, 3, (n, h, w, c)).astype(
        np.float32)).to(BF16)

    def kernel():
        k = rng.integers(-1, 2, (3, 3, c, c)) * (rng.random((3, 3, c, c))
                                                  < 0.15)
        return torch.from_numpy(k.astype(np.float32)).to(BF16)

    def vec(values):
        return torch.from_numpy(rng.choice(values, c).astype(np.float32))
    scales, shifts = (0.5, 1.0, 2.0), (-1.0, -0.5, 0.0, 0.5, 1.0)
    return (x, kernel(), kernel(), vec(scales), vec(shifts),
            torch.full((c,), 0.25), vec(scales), vec(shifts))


# frames crossing row tiles and a partial last tile (5x10x10x64: 605
# coordinates, three row tiles); bn = 64 at C = 16 and 32 (channels past C
# in the tile and the residual's load); bn = 128 at C = 80 (one column
# tile, channels past C) and C = 256 (two column tiles)
@pytest.mark.parametrize('n,h,w,c', [
    (5, 10, 10, 64), (2, 13, 6, 16), (3, 7, 9, 32), (2, 4, 6, 80),
    (2, 5, 5, 256), (1, 1, 1, 16)])
def test_emulated_kernel_matches_plain_version(n, h, w, c):
    x, w1, w2, a1, b1, alpha, a2, b2 = _exact_block(n, h, w, c, seed=c + n)
    v, y = emulate(x, w1, w2, a1, b1, alpha, a2, b2)
    v_ref = block_ops.bottleneck_bf16_conv1_ref(x, w1, a1, b1, alpha)
    y_ref = block_ops.bottleneck_bf16_conv2_ref(v_ref, x, w2, a2, b2)
    # every partial sum is exact: conv1's are multiples of 1/2, conv2's of
    # 1/8 (alpha's quarter of them), all below 2^24 of those steps
    u = block_ops.conv_ops.conv3x3_ref(
        (x.float() * a1 + b1).abs(), w1.float().abs())
    assert u.max() * 9 * c * 8 < 2 ** 24
    assert np.array_equal(v, v_ref.double().numpy())
    assert np.array_equal(y, y_ref.double().numpy())
    assert np.abs(y).max() > 0 and (v != 0).mean() > 0.2


def test_bf16_conv_design_on_cpu_takes_the_plain_version():
    """The earlier design's wrapper (on no path) runs the plain version on
    the CPU, counts nothing, and takes bfloat16 only."""
    x, w1, w2, a1, b1, alpha, a2, b2 = _exact_block(2, 5, 5, 32, seed=1)
    args = (w1, w2, a1, b1, alpha, a2, b2)
    want = block_ops.bottleneck_ir_fused_bf16_ref(x, *args)
    assert torch.equal(block_ops.bottleneck_ir_fused_bf16_conv(x, *args),
                       want)
    assert torch.equal(block_ops.bottleneck_ir_fused(x, *args), want)
    assert block_ops.bottleneck_ir_fused_bf16_conv.launches == 0
    assert block_ops.bottleneck_ir_fused.launches_bf16 == 0
    with pytest.raises(ValueError, match='bfloat16'):
        block_ops.bottleneck_ir_fused_bf16_conv(
            x.float(), *(t.float() for t in args))
