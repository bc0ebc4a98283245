"""Port's TCN block and TemporalConvNet vs fvt_tpu's Pallas kernel.

The JAX side runs the Pallas kernel in interpret mode; the port's wrapper
runs its plain version for tensors on the CPU.  Inputs are made with
numpy from a seed.  Tolerances: fp32 on both sides, summed in another
order, rtol 2e-4 / atol 2e-5 as tests/test_serving.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvt_tpu.models.tcn import TemporalConvNet as FlaxTCN
from fvt_tpu.ops.tcn_pallas import fused_temporal_block, tcn_forward_pallas
from fvt_tpu_torch.models.from_jax import tcn_state_from_flax
from fvt_tpu_torch.models.tcn import TemporalConvNet
from fvt_tpu_torch.ops import tcn as port_tcn

RTOL, ATOL = 2e-4, 2e-5
K = 5


def _block_inputs(rng, b, t, cin, cout, downsample):
    arrs = {
        'x': rng.normal(size=(b, t, cin)),
        'w1': rng.normal(size=(K, cin, cout)) * 0.1,
        'b1': rng.normal(size=(cout,)),
        'w2': rng.normal(size=(K, cout, cout)) * 0.1,
        'b2': rng.normal(size=(cout,)),
        'wd': rng.normal(size=(cin, cout)) * 0.1 if downsample else None,
        'bd': rng.normal(size=(cout,)) if downsample else None,
    }
    return {k: None if v is None else v.astype(np.float32)
            for k, v in arrs.items()}


# T=24 is shorter than the input halo 2*(K-1)*d for d=4 and d=8
@pytest.mark.parametrize('downsample', [True, False])
@pytest.mark.parametrize('dilation', [1, 2, 4, 8])
def test_fused_block_matches_pallas(dilation, downsample):
    rng = np.random.default_rng(dilation + 10 * downsample)
    cin = 24 if downsample else 16
    a = _block_inputs(rng, 2, 24, cin, 16, downsample)
    names = ('x', 'w1', 'b1', 'w2', 'b2', 'wd', 'bd')
    want = fused_temporal_block(
        *[None if a[n] is None else jnp.asarray(a[n]) for n in names],
        kernel_size=K, dilation=dilation, interpret=True)
    got = port_tcn.fused_temporal_block(
        *[None if a[n] is None else torch.from_numpy(a[n]) for n in names],
        kernel_size=K, dilation=dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_fused_block_short_row_first_frames():
    """T=3 under a halo of 16: every output frame sits in the causal pad,
    where conv2 must see zeros of h, not leaky(b1)."""
    rng = np.random.default_rng(3)
    a = _block_inputs(rng, 1, 3, 8, 8, False)
    names = ('x', 'w1', 'b1', 'w2', 'b2')
    want = fused_temporal_block(*[jnp.asarray(a[n]) for n in names],
                                kernel_size=K, dilation=2, interpret=True)
    got = port_tcn.fused_temporal_block(
        *[torch.from_numpy(a[n]) for n in names], kernel_size=K, dilation=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _perturbed_tcn_params(channels, cin, seed):
    """flax TCN init with g and the biases moved off their init values
    (at init g == ||v||, which would hide a dropped g)."""
    rng = np.random.default_rng(seed)
    model = FlaxTCN(channels, kernel_size=K, dropout=0.1)
    params = model.init(jax.random.key(seed), jnp.zeros((1, 8, cin)),
                        train=False)['params']

    def perturb(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name == 'g':
            return leaf * rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == 'bias':
            return leaf + rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        return leaf
    return model, jax.tree_util.tree_map_with_path(perturb, params)


def test_tcn_forward_matches_pallas():
    channels = [32, 32, 16, 16]
    cin = 24
    model, params = _perturbed_tcn_params(channels, cin, seed=0)
    x = np.random.default_rng(1).normal(size=(2, 40, cin)).astype(np.float32)

    want = tcn_forward_pallas(jnp.asarray(x), params, channels,
                              kernel_size=K, interpret=True)
    flax_eval = model.apply({'params': params}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(want), np.asarray(flax_eval),
                               rtol=RTOL, atol=ATOL)

    net = TemporalConvNet(cin, channels, K)
    net.load_state_dict(tcn_state_from_flax(params), strict=True)
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
        ref = net(torch.from_numpy(x), reference=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_weight_norm_matches_fvt_tpu():
    from fvt_tpu.models.layers import materialize_weight_norm
    from fvt_tpu_torch.models.layers import weight_norm

    rng = np.random.default_rng(2)
    v = rng.normal(size=(K, 12, 8)).astype(np.float32)
    v[:, :, 3] = 0.0  # a zero column takes the 1e-12 clamp
    g = rng.uniform(0.5, 1.5, size=(8,)).astype(np.float32)
    want = materialize_weight_norm(jnp.asarray(v), jnp.asarray(g))
    got = weight_norm(torch.from_numpy(v.transpose(2, 1, 0).copy()),
                      torch.from_numpy(g.reshape(-1, 1, 1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_wrapper_refuses_a_device_without_kernel():
    x = torch.zeros(1, 4, 8, device='meta')
    w = torch.zeros(K, 8, 8, device='meta')
    b = torch.zeros(8, device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        port_tcn.fused_temporal_block(x, w, b, w, b, kernel_size=K,
                                      dilation=1)
