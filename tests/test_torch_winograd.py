"""The port's Winograd F(2x2, 3x3) conv vs fvt_tpu's, on the same numpy
inputs.

``conv3x3_winograd_pallas`` runs in interpret mode; the port runs on the
CPU, where ``conv3x3_winograd`` takes its plain version
(``conv3x3_winograd_ref``, the port of the XLA-ops ``conv3x3_winograd``).
Against the direct convolution the tolerance is rtol = atol = 2e-4, that
of ``tests/test_winograd.py``: the transforms reorder and enlarge the
partial sums.  Against the JAX Winograd, which adds in the same order up
to the products, 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.ops import winograd as jax_winograd
from fvt_tpu_torch.ops import winograd as winograd_ops

SHAPES = [
    # (N, H, W, Cin, Cout): the small analogues of tests/test_winograd.py
    (4, 12, 12, 64, 64),
    (4, 10, 10, 128, 128),
    (4, 5, 5, 128, 128),      # odd extent: tiles padded and cropped
    (4, 10, 10, 64, 128),     # a widening conv1
    (3, 7, 9, 32, 16),        # odd both ways, ragged batch, Cin > Cout
    (1, 1, 1, 8, 4),
]


def _inputs(shape, seed):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    k = (rng.normal(size=(3, 3, ci, co)) * 0.1).astype(np.float32)
    return x, k


def _direct(x, k):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC')))


def test_transform_weights_matches_fvt_tpu():
    """U = G g G^T: the coefficients are 0, +-1, +-1/2, so both sides
    agree to the last bit but for the order of three-term sums (1e-6)."""
    k = (np.random.default_rng(0).normal(size=(3, 3, 16, 24)) * 0.1
         ).astype(np.float32)
    want = np.asarray(jax_winograd.transform_weights(jnp.asarray(k)))
    got = winograd_ops.transform_weights(torch.from_numpy(k))
    assert got.shape == (4, 4, 16, 24) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('shape', SHAPES)
def test_winograd_ref_matches_fvt_tpu_xla_version(shape):
    x, k = _inputs(shape, 1)
    want = np.asarray(jax_winograd.conv3x3_winograd(jnp.asarray(x),
                                                    jnp.asarray(k)))
    got = winograd_ops.conv3x3_winograd_ref(torch.from_numpy(x),
                                            torch.from_numpy(k))
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('shape', SHAPES)
def test_winograd_matches_pallas_interpret_and_direct(shape):
    x, k = _inputs(shape, 2)
    pallas = np.asarray(jax_winograd.conv3x3_winograd_pallas(
        jnp.asarray(x), jnp.asarray(k), interpret=True))
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    got = winograd_ops.conv3x3_winograd(xt, kt).numpy()
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _direct(x, k), rtol=2e-4, atol=2e-4)
    # the transformed weights the caller may keep, in either shape
    u = winograd_ops.transform_weights(kt)
    for kept in (u, u.reshape(16, *k.shape[2:])):
        again = winograd_ops.conv3x3_winograd(xt, kt, kept).numpy()
        np.testing.assert_array_equal(again, got)


def test_identity_kernel_copies_the_input():
    k = np.zeros((3, 3, 8, 8), np.float32)
    k[1, 1] = np.eye(8)
    x = np.random.default_rng(4).normal(size=(2, 7, 8, 8)).astype(np.float32)
    got = winograd_ops.conv3x3_winograd(torch.from_numpy(x),
                                        torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-6, atol=1e-6)


def test_winograd_refuses_grad_and_counts_no_cpu_launch():
    x = torch.zeros(1, 2, 2, 4)
    k = torch.zeros(3, 3, 4, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match='no backward'):
        winograd_ops.conv3x3_winograd(x, k)
    with torch.no_grad():
        assert winograd_ops.conv3x3_winograd(x, k).shape == (1, 2, 2, 4)
    assert winograd_ops.conv3x3_winograd.launches == 0
