"""The port's fused BottleneckIR block vs fvt_tpu's, on the same numpy
weights, carried over by ``from_jax``.

``fvt_tpu.ops.bottleneck_pallas.bottleneck_ir_fused`` runs in interpret
mode and the flax ``BottleneckIR`` in eval mode; the port runs on the
CPU, where ``bottleneck_ir_fused`` takes its plain version.  fp32 on both
sides through two 3x3 convs summed in another order: rtol = atol = 2e-5,
the tolerance of ``tests/test_bottleneck_pallas.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.models.arcface import BottleneckIR as FlaxBottleneckIR
from fvt_tpu.ops import bottleneck_pallas as jax_ops
from fvt_tpu_torch.models.arcface import BottleneckIR
from fvt_tpu_torch.models.from_jax import (bottleneck_state_from_flax,
                                           conv3x3_kernel_from_flax,
                                           fused_block_args_from_flax)
from fvt_tpu_torch.ops import bottleneck as bottleneck_ops


def _block(n, hw, c, seed, b1_scale=0.1, alpha=(0.1, 0.4)):
    """A flax identity block with every BN statistic, scale, bias and
    PReLU slope off its init value, as numpy trees, and an input."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, hw, hw, c)).astype(np.float32)
    block = FlaxBottleneckIR(in_channel=c, depth=c, stride=1)
    params = jax.tree_util.tree_map(
        np.asarray, block.init(jax.random.key(seed), jnp.asarray(x),
                               train=False)['params'])
    stats = {}
    for name in ('bn1', 'bn2'):
        params[name] = {
            'scale': rng.uniform(0.5, 1.5, c).astype(np.float32),
            'bias': (rng.normal(size=c) * b1_scale).astype(np.float32)}
        stats[name] = {'mean': (rng.normal(size=c) * 0.1).astype(np.float32),
                       'var': rng.uniform(0.5, 2.0, c).astype(np.float32)}
    params['prelu'] = {'alpha': rng.uniform(*alpha, c).astype(np.float32)}
    return block, params, stats, x


def _flax_eval(block, params, stats, x):
    return np.asarray(block.apply({'params': params, 'batch_stats': stats},
                                  jnp.asarray(x), train=False))


def test_bn_affine_matches_fvt_tpu():
    rng = np.random.default_rng(2)
    c = 32
    params = {'scale': rng.uniform(0.5, 2, c).astype(np.float32),
              'bias': rng.normal(size=c).astype(np.float32)}
    stats = {'mean': rng.normal(size=c).astype(np.float32),
             'var': rng.uniform(0.5, 2, c).astype(np.float32)}
    want = jax_ops.bn_affine(jax.tree_util.tree_map(jnp.asarray, params),
                             jax.tree_util.tree_map(jnp.asarray, stats))
    got = bottleneck_ops.bn_affine(
        torch.from_numpy(params['scale']), torch.from_numpy(params['bias']),
        torch.from_numpy(stats['mean']), torch.from_numpy(stats['var']))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize('hw,c,n', [(12, 64, 6), (8, 128, 4), (5, 128, 3),
                                    (1, 8, 2)])
def test_fused_block_matches_pallas_interpret_and_flax(hw, c, n):
    block, params, stats, x = _block(n, hw, c, seed=0)
    pallas = np.asarray(jax_ops.bottleneck_ir_fused(
        jnp.asarray(x), params, stats, batch_tile=2, interpret=True))
    args = fused_block_args_from_flax(params, stats)
    got = bottleneck_ops.bottleneck_ir_fused(torch.from_numpy(x), *args)
    assert got.shape == x.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(),
                               _flax_eval(block, params, stats, x),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('fused', [False, True])
def test_block_module_matches_flax_through_the_bridge(fused):
    """The port's BottleneckIR module on bridged weights, conv by conv and
    through ``fused=True``."""
    block, params, stats, x = _block(4, 10, 64, seed=1)
    port = BottleneckIR(64, 64, 1).eval()
    port.load_state_dict(bottleneck_state_from_flax(params, stats),
                         strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), fused=fused)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               _flax_eval(block, params, stats, x),
                               rtol=2e-5, atol=2e-5)


def test_bridge_carries_a_widening_block_and_the_kernel_layout():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    block = FlaxBottleneckIR(in_channel=16, depth=32, stride=2)
    variables = jax.tree_util.tree_map(
        np.asarray, block.init(jax.random.key(3), jnp.asarray(x),
                               train=False))
    state = bottleneck_state_from_flax(variables['params'],
                                       variables['batch_stats'])
    port = BottleneckIR(16, 32, 2).eval()
    port.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = np.asarray(block.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-5, atol=2e-5)
    k = variables['params']['conv1']['kernel']
    hwio = conv3x3_kernel_from_flax(k)
    assert hwio.shape == (3, 3, 16, 32) and hwio.is_contiguous()
    np.testing.assert_array_equal(
        state['res_layer.1.weight'].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(port.res_layer[1].kernel_weights()[0],
                                  hwio)


def test_conv1_pad_is_zero_not_b1():
    """bn1 comes before the zero pad: with a large bn1 shift a version
    that pads before the affine is off by ~|b1| * sum|w| at the border."""
    block, params, stats, x = _block(2, 6, 16, seed=4, b1_scale=20.0)
    args = fused_block_args_from_flax(params, stats)
    got = bottleneck_ops.bottleneck_ir_fused(torch.from_numpy(x), *args)
    want = _flax_eval(block, params, stats, x)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())
    w1, _, a1, b1 = args[:4]
    xt = torch.from_numpy(x)
    padded_first = bottleneck_ops._conv(
        torch.nn.functional.pad(xt, (0, 0, 1, 1, 1, 1)) * a1 + b1,
        w1)[:, 1:-1, 1:-1]
    right = bottleneck_ops._conv(xt * a1 + b1, w1)
    assert (padded_first - right).abs().max() > 1.0  # the trap is real here


def test_conv2_pad_is_zero_not_prelu_of_a_halo():
    """conv2 sees zeros outside the image.  With negative slopes and a
    shifted bn1, PReLU(conv1) of an out-of-image ring is far from zero;
    the block must not use it."""
    block, params, stats, x = _block(2, 6, 16, seed=5, b1_scale=2.0,
                                     alpha=(-0.9, -0.3))
    args = fused_block_args_from_flax(params, stats)
    got = bottleneck_ops.bottleneck_ir_fused(torch.from_numpy(x), *args)
    np.testing.assert_allclose(got.numpy(),
                               _flax_eval(block, params, stats, x),
                               rtol=2e-5, atol=5e-5)
    # the same block on a frame grown by a zero ring computes a non-zero
    # v on that ring: cropping it back gives another border
    w1, w2, a1, b1, alpha, a2, b2 = args
    xt = torch.from_numpy(x)
    grown = torch.nn.functional.pad(xt, (0, 0, 1, 1, 1, 1))
    t = grown * a1 + b1
    t[:, 0], t[:, -1], t[:, :, 0], t[:, :, -1] = 0, 0, 0, 0
    u = bottleneck_ops._conv(t, w1)
    v = torch.where(u > 0, u, alpha * u)
    wrong = (bottleneck_ops._conv(v, w2) * a2 + b2)[:, 1:-1, 1:-1] + xt
    assert (wrong - got).abs().max() > 1e-2


@pytest.mark.parametrize('shape', [(2400, 40, 40, 64), (2400, 20, 20, 128),
                                   (2400, 10, 10, 256), (2400, 5, 5, 512),
                                   (3, 7, 9, 32), (2, 12, 12, 128),
                                   (1, 1, 1, 4)])
def test_choose_tile_fits_the_kernel(shape):
    """Every ArcFace stage shape has a tile (the kernel has no other
    path): at most 16 conv1 pixels a thread row and 227 KB of shared
    memory."""
    n, h, w, c = shape
    tf, th, tw, rg = bottleneck_ops.choose_tile(n, h, w, c)
    assert 1 <= tf <= n and 1 <= th <= h and 1 <= tw <= w
    assert rg in bottleneck_ops.ROW_GROUPS
    pixels = bottleneck_ops.conv1_pixels(tf, th, tw, h, w)
    assert tf * th * tw <= pixels <= bottleneck_ops.MAX_SLOTS * rg
    assert (bottleneck_ops.smem_floats(tf, th, tw, rg, c)
            <= bottleneck_ops.MAX_SMEM_FLOATS)
    assert bottleneck_ops.smem_floats(1, 10, 10, 8, 256) == 49008


def test_no_tile_raises_and_grad_is_refused():
    with pytest.raises(ValueError, match='no tile'):
        bottleneck_ops.choose_tile(1, 3, 3, 8192)
    x = torch.zeros(1, 2, 2, 4, requires_grad=True)
    w = torch.zeros(3, 3, 4, 4)
    v = torch.ones(4)
    with pytest.raises(RuntimeError, match='no backward'):
        bottleneck_ops.bottleneck_ir_fused(x, w, w, v, v, v, v, v)
    assert bottleneck_ops.bottleneck_ir_fused.launches == 0
