"""The fused bfloat16 Winograd kernel's plan and summation order, on the
CPU (``csrc/winograd_bf16.cu``'s fused kernel runs only on the card, and
the CPU route is its plain version, which cannot see the kernel's tiling).

* The staging plan (``ops/winograd.py``'s :func:`fused_plan`, the C
  ``fused_plan``): a row tile of 128 tiles stages, for each pixel (r%2,
  c%2) of the extended tile grid and each 8-channel chunk, ``loads``
  copy-engine loads of 128 positions from position e(p0), each the im2col
  walk of the tensor map (traversal stride 2 from the lower corner (-1,
  -1) to the upper corners (2tw - W, 2th - H)) from the coordinate the
  producer computes, read (c%2, r%2) further (the im2col offsets).  The
  model here walks that box from those parameters and checks, at every
  tile and tap of every row tile, that the staged position the consumer
  reads holds the tap's pixel, that its load was issued and lies inside
  e_pad, and that the taps left zero are exactly the pad of
  ``input_transform``: at the ArcFace body's four H of ``chip_smoke.py``'s
  CONV_SHAPES and at phase 2's edge shapes (odd H or W, single pixels,
  ragged P, tiles across frames, four loads, a wide frame).
* The fragments: V formed from the staged pixels as the consumers form
  it (B^T's row a over two tap rows first, then the columns, each bfloat16
  add rounded) is ``input_transform``'s V bit for bit.
* The summation order, in float32: per 16-channel step and position row
  a, the products V_ab U_ab (16-term sums) straight into the output
  phases with A^T's signs, y rounded once.  Within one bfloat16 unit in the last place
  (plus ``FLOOR``, ``tests/test_torch_winograd_bf16.py``'s gate) of
  ``conv3x3_winograd_bf16_ref`` and of ``fvt_tpu``'s
  ``conv3x3_winograd_pallas`` in interpret mode on bfloat16 arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.ops import winograd as jax_winograd
from fvt_tpu_torch.ops import winograd as winograd_ops
from test_torch_winograd_bf16 import BF16, _apart, _bf16, _inputs
from test_torch_winograd_bf16 import one_torch_thread  # noqa: F401

ROWS, LOAD = winograd_ops.FUSED_ROWS, winograd_ops.FUSED_LOAD
# the H = W of chip_smoke.py's CONV_SHAPES (the plan does not depend on C)
CONV_H = (40, 20, 10, 5)
# phase 2's edge shapes (N, H, W)
EDGE = [(3, 7, 9), (1, 1, 1), (1, 2, 2), (5, 5, 5), (2, 13, 6),
        (3, 23, 45), (7, 10, 10), (300, 1, 1), (130, 2, 2), (1, 6, 400),
        (9, 2, 90)]
# B^T's row a over the tap rows: (r0, r1, sign of r1)
BT_ROWS = ((0, 2, -1), (1, 2, 1), (2, 1, -1), (1, 3, -1))
# A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]
AT = ((1, 1, 1, 0), (0, 1, -1, -1))


def _tiles(plan, p):
    """(frame, tile row, tile column) of tiles p."""
    f, r = np.divmod(p, plan['th'] * plan['tw'])
    return (f,) + np.divmod(r, plan['tw'])


def _position(plan, p):
    f, ty, tx = _tiles(plan, p)
    return f * plan['ext'] + ty * (plan['tw'] + 1) + tx


def _walk(plan, h, w, start, j):
    """The pixel (frame, row, column) of element j of a load that starts
    at extended position ``start``: the producer's start coordinate, then
    the im2col walk of the tensor map's box, every other column from -1
    to W - 1 + upper_w, then every other row, then the frames."""
    th, tw = plan['th'], plan['tw']
    upper_w, upper_h = 2 * tw - w, 2 * th - h
    ncol = (w - 1 + upper_w + 1) // 2 + 1
    nrow = (h - 1 + upper_h + 1) // 2 + 1
    f0, r = np.divmod(start, plan['ext'])
    h0, w0 = 2 * (r // (tw + 1)) - 1, 2 * (r % (tw + 1)) - 1
    walked = (f0 * nrow + (h0 + 1) // 2) * ncol + (w0 + 1) // 2 + j
    f, rem = np.divmod(walked, nrow * ncol)
    cy, cx = np.divmod(rem, ncol)
    return f, 2 * cy - 1, 2 * cx - 1


def _staged(plan, p, r, c):
    """Where the consumer of tile p reads tap (r, c): its row tile's first
    position e0, the staged index o, the load and its element."""
    e0 = _position(plan, p // ROWS * ROWS)
    o = _position(plan, p) - e0 + (r // 2) * (plan['tw'] + 1) + c // 2
    return e0, o, o // LOAD, o % LOAD


def _check_plan(n, h, w):
    plan = winograd_ops.fused_plan(n, h, w)
    p = np.arange(plan['P'])
    f, ty, tx = _tiles(plan, p)
    # input_transform's padded frame: 1 top and left, to 2*tiles + 2
    inside = np.zeros((2 * plan['th'] + 2, 2 * plan['tw'] + 2), bool)
    inside[1:h + 1, 1:w + 1] = True
    pads = 0
    for r in range(4):
        for c in range(4):
            e0, o, load, j = _staged(plan, p, r, c)
            assert (o >= 0).all() and (o < plan['e_pad']).all()
            assert (e0 + load * LOAD < plan['E']).all()  # the load was issued
            wf, row, col = _walk(plan, h, w, e0 + load * LOAD, j)
            row, col = row + r % 2, col + c % 2          # im2col offsets
            np.testing.assert_array_equal(wf, f)
            np.testing.assert_array_equal(row, 2 * ty - 1 + r)
            np.testing.assert_array_equal(col, 2 * tx - 1 + c)
            pad = (row < 0) | (row >= h) | (col < 0) | (col >= w)
            np.testing.assert_array_equal(
                pad, ~inside[2 * ty + r, 2 * tx + c])
            pads += int(pad.sum())
    return plan, pads


@pytest.mark.parametrize('h', CONV_H)
def test_plan_of_the_conv_shapes(h):
    """At 24 frames (row tiles across frames at every H), every tap of
    every tile where the consumer reads it; at the 2400 frames of a
    forward, e_pad = 256 (two loads a pixel and chunk) bounds every row
    tile's span."""
    plan, pads = _check_plan(24, h, h)
    assert plan['e_pad'] == 256 and pads > 0
    plan = winograd_ops.fused_plan(2400, h, h)
    p0 = np.arange(0, plan['P'], ROWS)
    last = np.minimum(p0 + ROWS, plan['P']) - 1
    span = _position(plan, last) + plan['tw'] + 3 - _position(plan, p0)
    assert plan['e_pad'] == 256 and span.max() <= 256


@pytest.mark.parametrize('shape', EDGE)
def test_plan_of_the_edge_shapes(shape):
    plan, _ = _check_plan(*shape)
    n, h, w = shape
    if (h, w) in ((1, 1), (2, 2)) and n > 64:
        assert plan['loads'] == 4  # 1x1 and 2x2 frames: four loads
    if w == 400:
        assert plan['loads'] == 3  # a wide frame: three, a ring of two


def test_a_row_tile_past_four_loads_is_refused():
    """A row tile across frames 800 wide would stage 932 positions; one
    frame 600 wide stages 430."""
    with pytest.raises(ValueError, match='more than 4 loads'):
        winograd_ops.fused_plan(2, 2, 800)
    assert winograd_ops.fused_plan(1, 2, 600)['loads'] == 4


def _stage(plan, x, e0):
    """A row tile's staged pixels (2, 2, e_pad, C) by the model's walk,
    zero outside the image (the copy engine's fill)."""
    n, h, w, c = x.shape
    o = np.arange(plan['e_pad'])
    load, j = np.divmod(o, LOAD)
    f, row, col = _walk(plan, h, w, e0 + load * LOAD, j)
    staged = torch.zeros(2, 2, plan['e_pad'], c, dtype=x.dtype)
    for pr in range(2):
        for pc in range(2):
            yy, xx = row + pr, col + pc
            ok = (f < n) & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            staged[pr, pc, ok] = x[f[ok], yy[ok], xx[ok]]
    return staged


@pytest.mark.parametrize('shape', [(3, 7, 9, 16), (2, 10, 10, 32),
                                   (20, 5, 5, 16), (40, 1, 1, 16),
                                   (2, 13, 6, 16)])
def test_fragments_from_the_staged_pixels_are_input_transforms_v(shape):
    """V_ab of every tile as the consumers form it from the staged
    pixels, bfloat16 add by add, equals ``input_transform``'s bits."""
    n, h, w, c = shape
    x = torch.from_numpy(_inputs(shape + (8,), 21)[0]).to(BF16)
    plan = winograd_ops.fused_plan(n, h, w)
    want = winograd_ops.input_transform(x)
    tw = plan['tw']
    for p0 in range(0, plan['P'], ROWS):
        p = np.arange(p0, min(p0 + ROWS, plan['P']))
        e0 = _position(plan, p0)
        staged = _stage(plan, x, e0)
        base = _position(plan, p) - e0

        def tap(r, c):
            return staged[r % 2, c % 2, base + (r // 2) * (tw + 1) + c // 2]

        for a, (r0, r1, sign) in enumerate(BT_ROWS):
            t = [tap(r0, c) + sign * tap(r1, c) for c in range(4)]
            v = (t[0] - t[2], t[1] + t[2], t[2] - t[1], t[1] - t[3])
            for b in range(4):
                assert v[b].dtype == BF16
                assert torch.equal(v[b], want[4 * a + b, p]), (a, b, p0)


def _fused_order(x, k):
    """y as the fused kernel sums it, in float32: per 16-channel step and
    position row a, each product V_ab U_ab (a 16-term sum) into the output
    phases 2i + j with the sign A^T[i][a] A^T[j][b]; y rounded to
    bfloat16 once."""
    n, h, w, c = x.shape
    co = k.shape[3]
    th, tw = -(-h // 2), -(-w // 2)
    v = winograd_ops.input_transform(x).float()
    u = winograd_ops.transform_weights_bf16(k).float()
    out = torch.zeros(4, v.shape[1], co)
    for s in range(0, c, 16):
        for a in range(4):
            for b in range(4):
                m = v[4 * a + b, :, s:s + 16] @ u[4 * a + b, s:s + 16]
                for i in range(2):
                    for j in range(2):
                        if AT[i][a] * AT[j][b]:
                            out[2 * i + j] += AT[i][a] * AT[j][b] * m
    y = out.reshape(2, 2, n, th, tw, co).permute(2, 3, 0, 4, 1, 5)
    return y.reshape(n, 2 * th, 2 * tw, co)[:, :h, :w].to(BF16)


@pytest.mark.parametrize('shape', [(2, 7, 9, 32, 16), (3, 10, 10, 64, 24),
                                   (1, 5, 5, 48, 8), (2, 20, 20, 128, 64)])
def test_fused_summation_order_within_one_ulp(shape):
    """The fused kernel's order of float32 sums against the plain version
    and ``fvt_tpu``'s Pallas kernel (interpret mode) on the same bfloat16
    arrays: within one unit in the last place (plus FLOOR)."""
    x, k = _inputs(shape, 23)
    xt, kt = torch.from_numpy(x).to(BF16), torch.from_numpy(k).to(BF16)
    got = _bf16(_fused_order(xt, kt))
    plain = _bf16(winograd_ops.conv3x3_winograd_bf16_ref(xt, kt))
    pallas = _bf16(jax_winograd.conv3x3_winograd_pallas(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, k)),
        interpret=True))
    for name, want in (('plain', plain), ('Pallas', pallas)):
        assert _apart(got, want) <= 1.0, (name, _apart(got, want))
