"""The port's nine-shifted-products 3x3 conv vs fvt_tpu's, on the same
numpy inputs.

``fvt_tpu.ops.conv_pallas.conv3x3_pallas`` runs in interpret mode; the
port runs on the CPU, where ``conv3x3`` takes its plain version.  Both
sides are fp32 sums of the same nine products in another order, so the
tolerance is rtol = atol = 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.ops.conv_pallas import conv3x3_pallas
from fvt_tpu_torch.ops import conv as conv_ops

SHAPES = [
    # (N, H, W, Cin, Cout): small analogues of the ArcFace stage shapes,
    # a widening conv, odd extents, single pixels
    (4, 12, 12, 64, 64),
    (3, 10, 10, 128, 128),
    (2, 5, 5, 128, 128),
    (2, 10, 10, 64, 128),
    (3, 7, 9, 32, 16),
    (1, 1, 1, 8, 4),
    (1, 2, 2, 4, 8),
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


@pytest.mark.parametrize('shape', SHAPES)
def test_conv3x3_matches_pallas_interpret(shape):
    x, k = _inputs(shape, 0)
    want = np.asarray(conv3x3_pallas(jnp.asarray(x), jnp.asarray(k),
                                     interpret=True))
    got = conv_ops.conv3x3(torch.from_numpy(x), torch.from_numpy(k))
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('shape', SHAPES)
def test_conv3x3_matches_direct_conv(shape):
    x, k = _inputs(shape, 1)
    got = conv_ops.conv3x3_ref(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), _direct(x, k), rtol=1e-5,
                               atol=1e-5)


def test_conv3x3_refuses_grad_and_other_devices():
    x = torch.zeros(1, 2, 2, 4, requires_grad=True)
    k = torch.zeros(3, 3, 4, 4)
    with pytest.raises(RuntimeError, match='no backward'):
        conv_ops.conv3x3(x, k)
    with torch.no_grad():
        assert conv_ops.conv3x3(x, k).shape == (1, 2, 2, 4)
    with pytest.raises(ValueError, match='no kernel for device'):
        conv_ops.conv3x3(torch.zeros(1, 2, 2, 4, device='meta'), k)
    assert conv_ops.conv3x3.launches == 0  # the CPU launches no kernel


@pytest.mark.parametrize('n,h,w', [(2400, 40, 40), (2400, 20, 20),
                                   (2400, 10, 10), (2400, 5, 5), (3, 7, 9),
                                   (1, 1, 1)])
def test_choose_tile_is_one_the_kernel_takes(n, h, w):
    """At most 160 pixels a block (10 a thread), inside the frame and the
    batch; at the ArcFace shapes no pixel slot of a block is idle by more
    than 1 in 10."""
    tf, th, tw = conv_ops.choose_tile(n, h, w)
    assert 1 <= tf <= n and 1 <= th <= h and 1 <= tw <= w
    pixels = tf * th * tw
    assert pixels <= conv_ops.ROW_GROUPS * conv_ops.SLOTS[-1]
    if n == 2400:
        slots = min(r for r in conv_ops.SLOTS
                    if conv_ops.ROW_GROUPS * r >= pixels)
        blocks = -(-n // tf) * -(-h // th) * -(-w // tw)
        assert n * h * w >= 0.9 * blocks * slots * conv_ops.ROW_GROUPS
