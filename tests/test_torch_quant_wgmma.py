"""The host side of the s8 conv's wgmma kernel (``csrc/conv3x3_s8_wgmma.cu``)
on the CPU, where no CUDA kernel runs: what it reads and where, made
explicit in plain PyTorch and held bit for bit against the conv's sum.

* ``pack_weights_s8``: its layout against the index formula, zeros past C
  and past Co;
* ``s8_plan`` (the C entry's plan, mirrored): the route, staged
  coordinates, loads, slots, ring steps, tiles and shared memory under
  227 KB, at the IR-50's eight int8 shapes (N = 2400), the four edge
  shapes of ``chip_smoke.py``'s phase 13, a C = 48 case and frames too
  wide for the padded line, which take the walk and are not refused;
* the kernel's addressing emulated: A staged from the padded line (stride
  1: one patch a tile and slice, the nine taps as row offsets into it) or
  from the per-tap walk (stride 2 and wide frames: the im2col walk of
  stride 1 or 2 from (-1, -1) with upper corners -1, tap (dy, dx) read at
  offsets (dx, dy)), rows past the tensor zero where the copy engine
  fills them and garbage where no load writes them, channels past C
  garbage (the copy engine fills them with zeros; their packed weights
  are zero either way); times the packed B in int64, a k32 slice and a
  tap at a time;
  the pad coordinates and rows past the last pixel dropped.  Equal to
  ``tap_sum`` bit for bit at those shapes, at N <= 3.
"""
import numpy as np
import pytest
import torch

from fvt_tpu_torch.ops import quant

# (N, H, W, C, Co, stride)
IR50_SHAPES = [(2400, 40, 40, 128, 128, 2), (2400, 20, 20, 128, 128, 1),
               (2400, 20, 20, 128, 256, 1), (2400, 20, 20, 256, 256, 2),
               (2400, 10, 10, 256, 256, 1), (2400, 10, 10, 256, 512, 1),
               (2400, 10, 10, 512, 512, 2), (2400, 5, 5, 512, 512, 1)]
EDGE_SHAPES = [(3, 7, 9, 80, 24, 2), (3, 7, 9, 80, 24, 1),
               (1, 5, 5, 16, 8, 2), (5, 11, 3, 128, 136, 1)]
# C = 48 (one and a half slices), and frames too wide for the padded line
MORE_SHAPES = [(2, 6, 7, 48, 16, 1), (2, 6, 7, 48, 16, 2),
               (1, 3, 600, 16, 8, 1), (1, 2, 511, 32, 16, 1)]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


def test_pack_weights_s8_layout():
    rng = np.random.default_rng(0)
    wq = _ints(rng, (136, 9, 80))
    p = quant.pack_weights_s8(wq)
    assert p.shape == (2, 3, 9, 2, quant.S8_BN, 16) and p.dtype == torch.int8
    assert p.is_contiguous()
    t, s, tap, h, n, k = np.meshgrid(*(np.arange(d) for d in p.shape),
                                     indexing='ij')
    co = quant.S8_BN * t + n
    c = 32 * s + 16 * h + k
    inside = (co < 136) & (c < 80)
    want = np.zeros(p.shape, np.int8)
    want[inside] = wq.numpy()[co[inside], tap[inside], c[inside]]
    np.testing.assert_array_equal(p.numpy(), want)
    assert not p[1, :, :, :, 8:].any()   # past Co = 136
    assert not p[:, 2, :, 1].any()       # channels 80..95, past C


@pytest.mark.parametrize('n,h,w,c,co,stride',
                         IR50_SHAPES + EDGE_SHAPES + MORE_SHAPES)
def test_s8_plan(n, h, w, c, co, stride):
    plan = quant.s8_plan(n, h, w, c, co, stride)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    assert (plan['ho'], plan['wo'], plan['m']) == (ho, wo, n * ho * wo)
    padded = stride == 1 and w <= 510
    assert plan['route'] == ('padded' if padded else 'walk')
    if padded:
        staged = 256 + 2 * (w + 1) + 2
        assert plan['p'] >= staged > plan['p'] - 128
        assert plan['q'] == n * (h + 1) * (w + 1)
        assert plan['rows'] == plan['q'] - (w + 2)
        assert plan['steps'] == -(-c // 32) and plan['taps_a_step'] == 9
        assert plan['loads'] <= 32  # a producer lane a load
    else:
        assert (plan['p'], plan['slots'], plan['taps_a_step']) == (256, 4, 3)
        assert plan['q'] == plan['rows'] == n * ho * wo
        assert plan['steps'] == 3 * -(-c // 32)
    assert plan['loads'] * 128 == plan['p']
    assert plan['tiles'] == -(-plan['rows'] // 256) * -(-co // 128)
    assert plan['tiles'] < 2 ** 31
    # the barriers, the ring's alignment, its slots of 32-byte rows and
    # weights, and the staged output rows, under 227 KB; no deeper ring fits
    walk = plan['route'] == 'walk'
    slot = (3 if walk else 1) * plan['p'] * 32 + plan['taps_a_step'] * 4096

    def smem(slots):
        return 128 + 1024 + slots * slot + 16 * 16 * 272
    assert plan['smem_bytes'] == smem(plan['slots']) <= 227 * 1024
    assert smem(plan['slots'] + 1) > 227 * 1024 or walk
    if padded and h == 10 and c == 256:  # the 26 convs of 10x10x256
        assert (plan['p'], plan['loads'], plan['slots']) == (384, 3, 3)
        assert plan['tiles'] == 1135 * (co // 128)


def test_s8_plan_refusals():
    for c, co, stride in ((24, 16, 1), (32, 12, 1), (32, 16, 3)):
        with pytest.raises(ValueError):
            quant.s8_plan(2, 5, 5, c, co, stride)


def _b_tap(packed, ct, s, tap):
    """The (S8_BN, 32) K-major B of one tap and slice of a column tile."""
    return packed[ct, s, tap].permute(1, 0, 2).reshape(quant.S8_BN, 32)


def emulate_s8(xq: torch.Tensor, wq: torch.Tensor, stride: int,
               rng: np.random.Generator) -> torch.Tensor:
    """The kernel's int32 sums (M, Co), made in int64 from what its copies
    stage and its wgmma read: see the module docstring."""
    n, h, w, c = xq.shape
    co = wq.shape[0]
    plan = quant.s8_plan(n, h, w, c, co, stride)
    packed = quant.pack_weights_s8(wq)
    ho, wo, m, p = plan['ho'], plan['wo'], plan['m'], plan['p']
    bm, ld = quant.S8_BM, quant.S8_LOAD
    slices = plan['slices']
    cpad = 32 * slices
    col_tiles = -(-co // quant.S8_BN)
    y = torch.full((m, col_tiles * quant.S8_BN), -2 ** 40, dtype=torch.int64)
    x64 = xq.long()

    def garbage(rows):  # what no load writes, and the channels past C
        return torch.from_numpy(rng.integers(-128, 128, (rows, cpad)))

    def past_c(a):
        a[:, c:] = garbage(len(a))[:, c:]
        return a

    if plan['route'] == 'padded':
        w1 = w + 1
        frame = (h + 1) * w1
        # the padded line: pixel (f, i, j) at f*frame + (i+1)*w1 + j+1
        line = torch.zeros(plan['q'], cpad, dtype=torch.int64)
        line.view(n, h + 1, w1, cpad)[:, 1:, 1:, :c] = x64
        for rt in range(-(-plan['rows'] // bm)):
            q0 = rt * bm
            staged = torch.zeros(p, cpad, dtype=torch.int64)
            for l in range(plan['loads']):
                lo = q0 + l * ld
                if lo >= plan['q']:
                    continue  # left out; the producer zeroes it
                hi = min(lo + ld, plan['q'])  # past the tensor: zero fill
                staged[l * ld:l * ld + hi - lo] = line[lo:hi]
            staged = past_c(staged)
            q = q0 + w1 + 1 + torch.arange(bm)
            keep = q < plan['q']
            f, rem = q // frame, q % frame
            i, j = rem // w1, rem % w1
            keep &= (i > 0) & (j > 0)
            pix = ((f * h + i - 1) * w + j - 1)[keep]
            for ct in range(col_tiles):
                acc = torch.zeros(bm, quant.S8_BN, dtype=torch.int64)
                for s in range(slices):
                    for tap in range(9):
                        shift = (tap // 3) * w1 + tap % 3
                        a = staged[shift:shift + bm, 32 * s:32 * s + 32]
                        acc += a @ _b_tap(packed, ct, s, tap).long().T
                y[pix, ct * quant.S8_BN:(ct + 1) * quant.S8_BN] = acc[keep]
    else:
        hw = ho * wo
        for rt in range(-(-m // bm)):
            m0 = rt * bm
            pos = m0 + torch.arange(bm)
            f, r = pos // hw, pos % hw
            oy, ox = r // wo, r % wo
            loaded = (m0 + (torch.arange(bm) // ld) * ld) < m
            for ct in range(col_tiles):
                acc = torch.zeros(bm, quant.S8_BN, dtype=torch.int64)
                for s in range(slices):
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        hi_ = oy * stride - 1 + dy
                        wi_ = ox * stride - 1 + dx
                        inside = ((f < n) & (hi_ >= 0) & (hi_ < h)
                                  & (wi_ >= 0) & (wi_ < w))
                        a = torch.zeros(bm, cpad, dtype=torch.int64)
                        a[inside, :c] = x64[f[inside], hi_[inside],
                                            wi_[inside]]
                        a[~loaded] = garbage(int((~loaded).sum()))
                        a = past_c(a)[:, 32 * s:32 * s + 32]
                        acc += a @ _b_tap(packed, ct, s, tap).long().T
                keep = pos < m
                y[pos[keep], ct * quant.S8_BN:(ct + 1) * quant.S8_BN] = \
                    acc[keep]
    return y[:, :co]


@pytest.mark.parametrize('n,h,w,c,co,stride', [
    # the IR-50's eight int8 shapes at N = 2 (3 where a frame is small)
    (2, 40, 40, 128, 128, 2), (2, 20, 20, 128, 128, 1),
    (2, 20, 20, 128, 256, 1), (2, 20, 20, 256, 256, 2),
    (3, 10, 10, 256, 256, 1), (3, 10, 10, 256, 512, 1),
    (3, 10, 10, 512, 512, 2), (3, 5, 5, 512, 512, 1)]
    + EDGE_SHAPES[:3] + [(3, 11, 3, 128, 136, 1)] + MORE_SHAPES)
def test_emulated_addressing_is_tap_sum(n, h, w, c, co, stride):
    rng = np.random.default_rng(n * 1000 + h * 10 + c + co + stride)
    xq = _ints(rng, (n, h, w, c))
    wq = _ints(rng, (co, 9, c))
    got = emulate_s8(xq, wq, stride, rng)
    want = quant.tap_sum(xq, wq, stride)
    assert torch.equal(got, want.long())
    # the sums stay within int32, the accumulator's range
    assert int(want.abs().max()) < 2 ** 31
