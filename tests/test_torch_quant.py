"""The port's int8 arithmetic (``fvt_tpu_torch/ops/quant.py``) against
``fvt_tpu/ops/quant.py``, bit for bit, on the CPU, where every wrapper runs
its plain version; and the host logic the two CUDA kernels
(``csrc/conv3x3_int8.cu``) depend on, which no CPU test can run.

* ``quantize_symmetric`` per tensor, per output channel and on an
  all-zero tensor: the int8 values and the scales equal ``fvt_tpu``'s;
* ``conv3x3_int8`` at strides 1 and 2, dynamic and with a calibrated
  ``x_scale`` (below the batch's amax, so values clip at +-127), float32
  and bfloat16 out, float32 and bfloat16 in, an odd H and W: equal to
  ``fvt_tpu``'s (both sum exactly; the divisions are IEEE divisions, the
  rounding half to even, the accumulator rounded to float32 once), as are
  ``conv3x3_int8_9mm`` and the plain ``conv3x3_int8_ref``;
* static with the batch's own amax equals dynamic bit for bit;
* the kernels' host side: ``quantize_weights``' (Co, 9, C) layout and
  scales, ``conv_plan``'s output sizes, grid, K steps and refusals,
  ``tap_rows`` (the im2col the kernel's copies address, zeros in the
  padding) times the weights equal to the conv's int32 sum at stride 2
  and odd sizes, and ``act_scale``'s true division.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from fvt_tpu.ops import quant as jax_quant
from fvt_tpu_torch.ops import quant


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize('shape,dims', [((4, 8, 8, 16), None),
                                        ((3, 3, 16, 24), (0, 1, 2)),
                                        ((2, 2), None)])
def test_quantize_symmetric_is_fvt_tpus(shape, dims):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    if shape == (2, 2):
        x[:] = 0.0  # all zero: scale 1e-12 / 127, q 0
    qj, sj = jax_quant.quantize_symmetric(jnp.asarray(x), dims)
    qt, st = quant.quantize_symmetric(torch.from_numpy(x), dims)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _inputs(h, w, in_dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, h, w, 32)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 32, 48)) * 0.1).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if in_dtype == 'bfloat16':
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
    return x, k, xj, xt


OUT = {'float32': (jnp.float32, torch.float32),
       'bfloat16': (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize('hw', [(10, 10), (7, 9)])
@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('static', [False, True])
@pytest.mark.parametrize('out', ['float32', 'bfloat16'])
@pytest.mark.parametrize('in_dtype', ['float32', 'bfloat16'])
def test_conv3x3_int8_is_fvt_tpus(hw, stride, static, out, in_dtype):
    x, k, xj, xt = _inputs(*hw, in_dtype)
    xs_j = xs_t = None
    if static:
        # a calibrated amax below the batch's: the tail clips at +-127
        amax = np.float32(np.abs(x).max() * 0.8)
        xs_t = quant.act_scale(torch.tensor([amax]))
        xs_j = jnp.maximum(jnp.float32(amax), 1e-12) / 127.0
        assert np.array_equal(xs_t.numpy(), np.asarray(xs_j).reshape(1))
    want = _np(jax_quant.conv3x3_int8(xj, jnp.asarray(k), stride,
                                      OUT[out][0], x_scale=xs_j))
    got = quant.conv3x3_int8(xt, torch.from_numpy(k), stride, OUT[out][1],
                             x_scale=xs_t)
    ref = quant.conv3x3_int8_ref(xt, torch.from_numpy(k), stride,
                                 OUT[out][1], x_scale=xs_t)
    assert got.dtype == OUT[out][1]
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(ref.float().numpy(), want)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('out', ['float32', 'bfloat16'])
def test_conv3x3_int8_9mm_is_fvt_tpus(stride, out):
    x, k, xj, xt = _inputs(7, 9, 'float32', seed=2)
    want = _np(jax_quant.conv3x3_int8_9mm(xj, jnp.asarray(k), stride,
                                          OUT[out][0]))
    got = quant.conv3x3_int8_9mm(xt, torch.from_numpy(k), stride,
                                 OUT[out][1])
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_static_with_the_batch_amax_is_dynamic():
    """``tests/test_quant.py``'s pin, on the port: the same scale gives
    the same int8 values, sums and scaling."""
    x, k, _, xt = _inputs(8, 8, 'float32', seed=3)
    kt = torch.from_numpy(k)
    dyn = quant.conv3x3_int8(xt, kt, out_dtype=torch.float32)
    _, scale, amax = quant.quantize_int8(xt)
    assert amax.item() == np.abs(x).max()
    sta = quant.conv3x3_int8(xt, kt, out_dtype=torch.float32,
                             x_scale=quant.act_scale(amax))
    assert torch.equal(dyn, sta)
    q, s2, none = quant.quantize_int8(xt, scale)
    assert none is None and s2 is scale
    assert torch.equal(q, quant.quantize_symmetric(xt)[0])


def test_quantize_weights_layout():
    rng = np.random.default_rng(4)
    k = torch.from_numpy(rng.standard_normal((3, 3, 32, 24))
                         .astype(np.float32))
    wq, wscale = quant.quantize_weights(k)
    q, scale = quant.quantize_symmetric(k, dims=(0, 1, 2))
    assert wq.shape == (24, 9, 32) and wq.is_contiguous()
    assert wscale.shape == (24,) and torch.equal(wscale, scale.reshape(24))
    for co, t, c in ((0, 0, 0), (5, 4, 17), (23, 8, 31), (11, 2, 3)):
        assert wq[co, t, c] == q[t // 3, t % 3, c, co]


@pytest.mark.parametrize('n,h,w,c,co,stride', [
    (2400, 40, 40, 128, 128, 2), (2400, 20, 20, 128, 256, 1),
    (2400, 10, 10, 512, 512, 2), (3, 7, 9, 80, 24, 2), (1, 5, 5, 16, 8, 1),
    (5, 11, 3, 128, 136, 1)])
def test_conv_plan(n, h, w, c, co, stride):
    plan = quant.conv_plan(n, h, w, c, co, stride)
    y = F.conv2d(torch.zeros(1, 1, h, w), torch.zeros(1, 1, 3, 3), None,
                 stride, 1)
    assert (plan['ho'], plan['wo']) == tuple(y.shape[2:])
    assert plan['m'] == n * plan['ho'] * plan['wo']
    gm, gn = plan['grid']
    assert (gm - 1) * quant.TILE_M < plan['m'] <= gm * quant.TILE_M
    assert (gn - 1) * quant.TILE_N < co <= gn * quant.TILE_N
    assert plan['k_steps'] * quant.TILE_K >= 9 * c
    assert plan['k_steps'] == 9 * -(-c // quant.TILE_K)
    assert plan['smem_bytes'] == 61440  # the ring, under the 227 KB


@pytest.mark.parametrize('c,co,stride', [(24, 16, 1), (32, 12, 1),
                                         (32, 16, 3)])
def test_conv_plan_refusals(c, co, stride):
    with pytest.raises(ValueError):
        quant.conv_plan(2, 5, 5, c, co, stride)


@pytest.mark.parametrize('h,w,stride', [(7, 9, 2), (6, 5, 1), (5, 5, 2)])
def test_tap_rows_address_the_padded_input(h, w, stride):
    rng = np.random.default_rng(5)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, h, w, 16), np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (8, 9, 16), np.int8))
    rows = quant.tap_rows(xq, stride)
    ho, wo = quant.out_size(h, stride), quant.out_size(w, stride)
    assert rows.shape == (2 * ho * wo, 9, 16)
    for m, t in ((0, 0), (2 * ho * wo - 1, 8), (wo, 4), (1, 2)):
        n, r = divmod(m, ho * wo)
        y, x = divmod(r, wo)
        hi, wi = y * stride + t // 3 - 1, x * stride + t % 3 - 1
        inside = 0 <= hi < h and 0 <= wi < w
        want = xq[n, hi, wi] if inside else torch.zeros(16, dtype=torch.int8)
        assert torch.equal(rows[m, t], want)
    acc = rows.reshape(len(rows), -1).long() @ wq.reshape(8, -1).long().T
    assert torch.equal(acc.double(), quant.tap_sum(xq, wq, stride))


def test_act_scale_divides():
    amax = torch.tensor([3.0, 0.0, 1e-20, 7.25], dtype=torch.float32)
    want = (np.maximum(amax.numpy(), np.float32(1e-12))
            / np.float32(127.0)).astype(np.float32)
    np.testing.assert_array_equal(quant.act_scale(amax).numpy(), want)
