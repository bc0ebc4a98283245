"""The split-TF32 (3xTF32) float32 conv of the port, on the CPU.

The CUDA kernel (``csrc/conv3x3_tf32x3.cu``) runs only on the card; what
it computes is held here: :func:`split_tf32` against an independent
float64 rounding (what ``cvt.rna.tf32.f32`` does), the layout of
:func:`pack_weights_tf32`, and :func:`conv3x3_tf32x3_ref`, the emulation
of the kernel's three TF32 products, against ``fvt_tpu``'s
``conv3x3_pallas`` in interpret mode within the float32 gate (rtol = atol
= 1e-4, ``chip_smoke.py``), at the fp32 test's shapes and at 5x5x512,
where a sum runs over K = 9 * 512 = 4608 products.  One TF32 product alone
misses that gate there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fvt_tpu.ops.conv_pallas import conv3x3_pallas
from fvt_tpu_torch.ops import conv as conv_ops
from test_torch_conv import SHAPES as FP32_SHAPES

GATE = 1e-4
DEEP = (2, 5, 5, 512, 512)
SHAPES = FP32_SHAPES + [DEEP]


def _tf32_ref(t: np.ndarray) -> np.ndarray:
    """float32 ``t`` rounded to TF32 (11 significant bits; at the bottom of
    the range the quantum 2^-136 of fp32's subnormals shifted by 13 bits),
    to nearest, ties away from zero, in float64."""
    a = np.abs(t.astype(np.float64))
    _, e = np.frexp(a)  # a = m * 2^e, m in [0.5, 1)
    q = np.maximum(np.ldexp(1.0, e - 11), 2.0 ** -136)
    return (np.sign(t) * np.floor(a / q + 0.5) * q).astype(np.float32)


def _low_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) & 0x1FFF


finite = st.floats(min_value=-2.0 ** 127, max_value=2.0 ** 127, width=32,
                   allow_nan=False, allow_infinity=False,
                   allow_subnormal=True, exclude_min=True, exclude_max=True)


@settings(max_examples=400, deadline=None, database=None)
@given(st.lists(finite, min_size=1, max_size=64))
def test_split_tf32_is_cvt_rna_twice(values):
    """hi = rna(t) and lo = rna(t - hi): both TF32 values (low 13 bits
    zero), equal to the float64 rounding; t - hi is exact in float32;
    |lo| <= 2^-11 |t| (for a subnormal t: the quantum's half, 2^-137);
    and lo's own rounding leaves at most one unit of t's last place,
    2^-23 |t|, of t out of hi + lo (where t - hi is below the normal range
    the quantum's half, 2^-137, bounds it)."""
    t = torch.tensor(values + [0.0, -0.0, 2.0 ** -149, -2.0 ** -126,
                               1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -23],
                     dtype=torch.float32)
    hi, lo = conv_ops.split_tf32(t)
    assert hi.dtype == lo.dtype == torch.float32
    assert not _low_bits(hi).any() and not _low_bits(lo).any()
    tn, hn, ln = (v.numpy().astype(np.float64) for v in (t, hi, lo))
    np.testing.assert_array_equal(hi.numpy(), _tf32_ref(t.numpy()))
    residual = (t - hi).numpy()
    np.testing.assert_array_equal(residual.astype(np.float64), tn - hn)
    np.testing.assert_array_equal(lo.numpy(), _tf32_ref(residual))
    assert (np.abs(ln) <= np.maximum(2.0 ** -11 * np.abs(tn),
                                     2.0 ** -137)).all()
    assert (np.abs(tn - hn - ln) <= np.maximum(2.0 ** -23 * np.abs(tn),
                                               2.0 ** -137)).all()
    # ties go away from zero, as cvt.rna rounds
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    np.testing.assert_array_equal(conv_ops.split_tf32(tie)[0].numpy(),
                                  [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)])


def test_split_tf32_keeps_non_finite_values_and_takes_float32_only():
    t = torch.tensor([float('inf'), -float('inf'), float('nan')])
    hi, lo = conv_ops.split_tf32(t)
    assert torch.equal(hi[:2], t[:2]) and hi[2].isnan()
    assert not lo.any()
    with pytest.raises(ValueError, match='float32'):
        conv_ops.split_tf32(t.double())


@pytest.mark.parametrize('c,co', [(4, 4), (8, 4), (20, 36), (64, 64),
                                  (64, 200), (512, 128)])
def test_pack_weights_tf32_is_the_layout_the_kernel_copies(c, co):
    """``part[t, s, tap, h, n8, n, k]`` is the split weight of tap ``tap``,
    input channel ``8*s + 4*h + k`` and output channel ``bn*t + 8*n8 +
    n``, and 0 beyond C or Co: per (column tile, 8-channel slice) one
    contiguous block of K-major core matrices, 4 input channels
    innermost."""
    rng = np.random.default_rng(c + co)
    k = torch.from_numpy(rng.normal(size=(3, 3, c, co)).astype(np.float32))
    bn = conv_ops.column_tile(co)
    tiles, slices = -(-co // bn), -(-c // 8)
    parts = conv_ops.pack_weights_tf32(k)
    whole = torch.zeros(9, slices * 8, tiles * bn)
    whole[:, :c, :co] = k.reshape(9, c, co)
    for part, want in zip(parts, conv_ops.split_tf32(whole)):
        assert part.shape == (tiles, slices, 9, 2, bn // 8, 8, 4)
        assert part.dtype == torch.float32 and part.is_contiguous()
        t, s, tap, h, n8, n, kk = np.meshgrid(
            *(np.arange(d) for d in part.shape), indexing='ij')
        np.testing.assert_array_equal(
            part.numpy(),
            want.numpy()[tap, 8 * s + 4 * h + kk, bn * t + 8 * n8 + n])
    hi, lo = parts
    assert not _low_bits(hi).any() and not _low_bits(lo).any()


def _inputs(shape, seed):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    k = (rng.normal(size=(3, 3, ci, co)) * (9 * ci) ** -0.5).astype(np.float32)
    return x, k


@pytest.mark.parametrize('shape', SHAPES)
def test_conv3x3_tf32x3_ref_meets_the_fp32_gate(shape):
    """The kernel's three TF32 products against fvt_tpu's float32 Pallas
    kernel (interpret mode) within rtol = atol = 1e-4, the gate the card
    holds the kernel to; and against the plain float32 version."""
    x, k = _inputs(shape, 5)
    want = np.asarray(conv3x3_pallas(jnp.asarray(x), jnp.asarray(k),
                                     interpret=True))
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    got = conv_ops.conv3x3_tf32x3_ref(xt, kt)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=GATE, atol=GATE)
    np.testing.assert_allclose(got.numpy(), conv_ops.conv3x3_ref(xt, kt),
                               rtol=GATE, atol=GATE)


def test_one_tf32_product_misses_the_gate_at_k_4608():
    """Why three products: hi*hi alone (plain TF32) is off by more than
    the gate over K = 4608, the split stays far inside it."""
    x, k = (torch.from_numpy(a) for a in _inputs(DEEP, 6))
    want = conv_ops.conv3x3_ref(x, k)
    plain_tf32 = conv_ops.conv3x3_ref(conv_ops.split_tf32(x)[0],
                                      conv_ops.split_tf32(k)[0])
    split = conv_ops.conv3x3_tf32x3_ref(x, k)
    assert (plain_tf32 - want).abs().max() > GATE
    assert (split - want).abs().max() < GATE / 10


def test_conv3x3_fp32_on_cpu_takes_the_plain_version():
    """On the CPU neither float32 kernel launches: conv3x3 and
    conv3x3_simt return the plain version's bits, any channel count."""
    x, k = (torch.from_numpy(a) for a in _inputs((2, 4, 3, 12, 8), 7))
    for fn in (conv_ops.conv3x3, conv_ops.conv3x3_simt):
        assert torch.equal(fn(x, k), conv_ops.conv3x3_ref(x, k))
    x, k = (torch.from_numpy(a) for a in _inputs((1, 2, 2, 6, 10), 7))
    assert conv_ops.conv3x3(x, k).shape == (1, 2, 2, 10)
    assert conv_ops.conv3x3.launches == conv_ops.conv3x3.launches_fp32 == 0
    assert conv_ops.conv3x3_simt.launches == 0
    with pytest.raises(ValueError, match='takes float32'):
        conv_ops.conv3x3_simt(x.bfloat16(), k.bfloat16())


def test_shifted_kernel_module_keeps_the_split_weights():
    """``Conv3x3(impl='shifted_kernel')`` in float32 packs the split
    weights once and packs them again when ``weight`` is written."""
    from fvt_tpu_torch.models.arcface import Conv3x3

    conv = Conv3x3(8, 12, impl='shifted_kernel')
    torch.nn.init.normal_(conv.weight)
    _, hwio, (hi, lo) = conv.cast_weights()
    assert conv.cast_weights()[2][0] is hi
    for part, want in zip((hi, lo), conv_ops.pack_weights_tf32(hwio)):
        assert torch.equal(part, want)
    with torch.no_grad():
        conv.weight.mul_(2.0)
    assert torch.equal(conv.cast_weights()[2][0], 2.0 * hi)
    assert Conv3x3(6, 12, impl='shifted_kernel').cast_weights()[2] is None
