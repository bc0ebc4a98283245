"""The port's 3x3 conv in bfloat16 vs fvt_tpu's, on the same numpy inputs.

Under ``--amp`` fvt_tpu hands ``conv3x3_pallas`` bfloat16 arrays: the
Pallas kernel multiplies them, sums the nine products in float32 and
rounds to bfloat16 once.  Here it runs in interpret mode; the port runs on
the CPU, where ``conv3x3`` takes its plain version, which must have the
same semantics.  Both sides sum exact products in float32 in another order
and round once, so they may differ by one bfloat16 unit in the last place
where the float32 sums straddle a rounding boundary: |got - want| <= 2^-7
|want| + 2^-9, compared as float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fvt_tpu.ops.conv_pallas import conv3x3_pallas
from fvt_tpu_torch.kernels import build
from fvt_tpu_torch.ops import conv as conv_ops
from test_torch_conv import SHAPES as FP32_SHAPES

# the fp32 test's shapes, and the smallest channel count the bfloat16
# kernel takes
SHAPES = FP32_SHAPES + [(2, 6, 5, 16, 24)]
RTOL, ATOL = 2.0 ** -7, 2.0 ** -9


def _inputs(shape, seed):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    k = (rng.normal(size=(3, 3, ci, co)) * (9 * ci) ** -0.5).astype(np.float32)
    return x, k


def _bf16(a):
    """The same bfloat16 values for both frameworks (both round to nearest
    even from float32)."""
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def _per_tap(x, kernel):
    """The plain version as it was before bfloat16 support: the sums are
    kept in x's type, so a bfloat16 x rounds after every tap."""
    n, h, w, c = x.shape
    co = kernel.shape[3]
    xpad = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = x.new_zeros((n * h * w, co))
    for dy in range(3):
        for dx in range(3):
            xs = xpad[:, dy:dy + h, dx:dx + w, :].reshape(n * h * w, c)
            out.addmm_(xs, kernel[dy, dx])
    return out.reshape(n, h, w, co)


@pytest.mark.parametrize('shape', SHAPES)
def test_conv3x3_bf16_matches_pallas_interpret(shape):
    x, k = _inputs(shape, 0)
    (xj, xt), (kj, kt) = _bf16(x), _bf16(k)
    want = conv3x3_pallas(xj, kj, interpret=True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = conv_ops.conv3x3_ref(xt, kt)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert got.is_contiguous()
    got = got.float().numpy()
    excess = np.abs(got - want) - RTOL * np.abs(want) - ATOL
    assert excess.max() <= 0, excess.max()
    # one-unit flips are rare: the mean difference is far below one unit
    assert np.abs(got - want).mean() <= 1e-4 * np.abs(want).mean()


@pytest.mark.parametrize('shape', SHAPES)
def test_conv3x3_bf16_close_to_fp32_direct_conv(shape):
    """bfloat16 noise against the float32 direct conv: the median relative
    error is bounded by the mantissa's width (tests/test_winograd.py)."""
    x, k = _inputs(shape, 1)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC')))
    out = conv_ops.conv3x3_ref(_bf16(x)[1], _bf16(k)[1]).float().numpy()
    err = np.abs(out - ref) / (np.abs(ref) + 1e-3)
    assert np.median(err) < 2e-2, np.median(err)


def test_conv3x3_bf16_rounds_once_and_not_after_every_tap():
    """One channel carries 1; the first tap weighs 256, the other eight
    0.5.  The float32 sum of an interior pixel is 260, a bfloat16 value;
    a sum kept in bfloat16 stays at 256, because 256.5 rounds back to 256
    eight times."""
    x = np.zeros((1, 3, 3, 16), np.float32)
    x[..., 0] = 1.0
    k = np.zeros((3, 3, 16, 8), np.float32)
    k[:, :, 0, :] = 0.5
    k[0, 0, 0, :] = 256.0
    (xj, xt), (kj, kt) = _bf16(x), _bf16(k)
    assert _per_tap(xt, kt)[0, 1, 1, 0].item() == 256.0
    got = conv_ops.conv3x3_ref(xt, kt)
    assert got.dtype == torch.bfloat16 and got[0, 1, 1, 0].item() == 260.0
    want = conv3x3_pallas(xj, kj, interpret=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize('shape', [SHAPES[0], SHAPES[4], SHAPES[5]])
def test_conv3x3_ref_fp32_is_bit_identical_to_before(shape):
    x, k = (torch.from_numpy(a) for a in _inputs(shape, 2))
    got = conv_ops.conv3x3_ref(x, k)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _per_tap(x, k).numpy())


def test_conv3x3_on_cpu_bf16_takes_the_plain_version():
    x, k = (torch.from_numpy(a).to(torch.bfloat16)
            for a in _inputs(SHAPES[-1], 3))
    got = conv_ops.conv3x3(x, k)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, conv_ops.conv3x3_ref(x, k))
    # on the CPU no channel count is refused: the plain version takes all
    x, k = (torch.from_numpy(a).to(torch.bfloat16)
            for a in _inputs((1, 2, 2, 20, 12), 3))
    assert conv_ops.conv3x3(x, k).shape == (1, 2, 2, 12)
    assert conv_ops.conv3x3.launches == 0
    assert conv_ops.conv3x3.launches_bf16 == 0


@pytest.mark.parametrize('xdtype,kdtype,match', [
    (torch.bfloat16, torch.float32, 'both in one type'),
    (torch.float32, torch.bfloat16, 'both in one type'),
    (torch.float16, torch.float16, 'float32 or bfloat16'),
    (torch.float64, torch.float64, 'float32 or bfloat16'),
])
def test_conv3x3_refuses_other_and_mixed_types(xdtype, kdtype, match):
    x = torch.zeros(1, 2, 2, 16, dtype=xdtype)
    k = torch.zeros(3, 3, 16, 8, dtype=kdtype)
    with pytest.raises(ValueError, match=match):
        conv_ops.conv3x3(x, k)


@pytest.mark.parametrize('c,co', [(16, 8), (32, 64), (48, 72), (64, 200),
                                  (16, 256)])
def test_pack_weights_is_the_layout_the_kernel_copies(c, co):
    """``packed[t, s, tap, h, n8, k, n]`` is the weight of tap ``tap``,
    input channel ``16*s + 8*h + k`` and output channel ``bn*t + 8*n8 +
    n``, and 0 beyond Co: per (column tile, 16-channel slice) one
    contiguous block of 8x8 core matrices, 8 output channels innermost."""
    rng = np.random.default_rng(4)
    k = torch.from_numpy(rng.normal(size=(3, 3, c, co)).astype(np.float32))
    k = k.to(torch.bfloat16)
    bn = conv_ops.column_tile(co)
    assert bn == (64 if co <= 64 else 128)
    tiles = -(-co // bn)
    packed = conv_ops.pack_weights(k)
    assert packed.shape == (tiles, c // 16, 9, 2, bn // 8, 8, 8)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    want = torch.zeros(9, c, tiles * bn, dtype=torch.bfloat16)
    want[:, :, :co] = k.reshape(9, c, co)
    t, s, tap, h, n8, kk, n = np.meshgrid(
        *(np.arange(d) for d in packed.shape), indexing='ij')
    np.testing.assert_array_equal(
        packed.float().numpy(),
        want.float().numpy()[tap, 16 * s + 8 * h + kk, bn * t + 8 * n8 + n])


def test_check_tensor_takes_the_expected_type():
    x = torch.zeros(2, 16, dtype=torch.bfloat16)
    build.check_tensor('x', x, (2, 16), x.device, torch.bfloat16)
    with pytest.raises(ValueError, match='the kernel takes torch.float32'):
        build.check_tensor('x', x, (2, 16), x.device)
    with pytest.raises(ValueError, match='the kernel takes torch.bfloat16'):
        build.check_tensor('x', x.float(), (2, 16), x.device, torch.bfloat16)
