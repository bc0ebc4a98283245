"""The port's train-mode TCN block vs fvt_tpu's fused Pallas block.

The same numpy inputs and dropout masks go through
``fvt_tpu.ops.tcn_pallas.fused_temporal_block_train`` (Pallas in
interpret mode, gradients by ``jax.grad`` through its custom VJP) and
through the port's function on the CPU, where the wrapper runs its plain
version under ordinary autograd.  Tolerances are those of
``tests/test_tcn_pallas.py``: output rtol = atol = 1e-5, the six
gradients rtol = atol = 2e-4 (fp32, sums in another order).

``_block_bwd_ref`` spells the arithmetic of the CUDA backward kernels
(the gather form, from the saved pre-activations) in plain PyTorch; it is
held against autograd of the plain forward, so the formula the ``.cu``
file implements is tested here although the kernel cannot run.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvt_tpu.ops.tcn_pallas import fused_temporal_block_train as jax_block
from fvt_tpu_torch.ops import tcn as port_tcn

GRAD_NAMES = ('x', 'w1', 'b1', 'w2', 'b2', 'res')


def _inputs(seed, ks, b, t, cin, cout, dropout):
    rng = np.random.default_rng(seed)
    a = {'x': rng.normal(size=(b, t, cin)),
         'w1': rng.normal(size=(ks, cin, cout)),
         'b1': rng.normal(size=(cout,)),
         'w2': rng.normal(size=(ks, cout, cout)),
         'b2': rng.normal(size=(cout,)),
         'res': rng.normal(size=(b, t, cout)),
         'tgt': rng.normal(size=(b, t, cout))}
    keep = 1.0 - dropout
    for m in ('m1', 'm2'):
        a[m] = ((rng.random((b, t, cout)) < keep) / keep if dropout
                else np.ones((b, t, cout)))
    return {k: v.astype(np.float32) for k, v in a.items()}


def _torch_args(a, dtype=torch.float32):
    t = {k: torch.from_numpy(v).to(dtype) for k, v in a.items()}
    for k in GRAD_NAMES:
        t[k].requires_grad_(True)
    return t


# the last case has T = 3 under a halo of (K-1)*d = 8 frames
@pytest.mark.parametrize('ks,dil,b,t,cin,cout,dropout', [
    (3, 2, 2, 16, 8, 16, 0.0),
    (3, 2, 2, 16, 8, 16, 0.3),
    (3, 4, 2, 3, 8, 16, 0.3),
])
def test_train_block_matches_pallas(ks, dil, b, t, cin, cout, dropout):
    _check_against_pallas(_inputs(0, ks, b, t, cin, cout, dropout), ks, dil)


@pytest.mark.parametrize('dil', [1, 8])
def test_train_block_matches_pallas_at_the_mfcc_width(dil):
    """Cin = 39, which the card runs on zero channels, with the weights at
    the model's init scale (``(K*Cin)**-0.5``): at unit weights the
    outputs reach the hundreds and the float32 sums' order alone moves a
    cancelled one past the 1e-5 gate."""
    ks, cin, cout = 5, 39, 32
    a = _inputs(5, ks, 2, 40, cin, cout, 0.3)
    a['w1'] = a['w1'] * np.float32((ks * cin) ** -0.5)
    a['w2'] = a['w2'] * np.float32((ks * cout) ** -0.5)
    _check_against_pallas(a, ks, dil)


def _check_against_pallas(a, ks, dil):
    j = {k: jnp.asarray(v) for k, v in a.items()}

    def jax_out(x, w1, b1, w2, b2, res):
        return jax_block(x, w1, b1, w2, b2, j['m1'], j['m2'], res,
                         kernel_size=ks, dilation=dil, interpret=True)

    jargs = tuple(j[k] for k in GRAD_NAMES)
    want = jax_out(*jargs)
    want_grads = jax.grad(
        lambda *p: jnp.sum((jax_out(*p) - j['tgt']) ** 2),
        argnums=tuple(range(6)))(*jargs)

    p = _torch_args(a)
    got = port_tcn.fused_temporal_block_train(
        p['x'], p['w1'], p['b1'], p['w2'], p['b2'], p['m1'], p['m2'],
        p['res'], kernel_size=ks, dilation=dil)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    got_grads = torch.autograd.grad(((got - p['tgt']) ** 2).sum(),
                                    [p[k] for k in GRAD_NAMES])
    for name, g, w in zip(GRAD_NAMES, got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize('ks,dil,t,dropout', [(3, 2, 16, 0.3), (3, 4, 3, 0.3),
                                              (5, 1, 9, 0.0)])
def test_backward_formula_matches_autograd(ks, dil, t, dropout):
    """``_block_bwd_ref`` (what the CUDA backward computes) against
    autograd of the plain forward, in float64: rtol = atol = 1e-10."""
    a = _inputs(1, ks, 2, t, 8, 12, dropout)
    p = _torch_args(a, torch.float64)
    out = port_tcn.fused_temporal_block_train_ref(
        p['x'], p['w1'], p['b1'], p['w2'], p['b2'], p['m1'], p['m2'],
        p['res'], kernel_size=ks, dilation=dil)
    g = p['tgt']  # any cotangent
    want = torch.autograd.grad(out, [p[k] for k in GRAD_NAMES], g)
    with torch.no_grad():
        a1 = port_tcn._causal_conv(p['x'], p['w1'], p['b1'], dil)
        h = port_tcn._leaky(a1) * p['m1']
        a2 = port_tcn._causal_conv(h, p['w2'], p['b2'], dil)
        got = port_tcn._block_bwd_ref(
            p['x'], p['w1'], p['w2'], p['m1'], p['m2'], p['res'], a1, a2, g,
            dilation=dil)
    for name, gg, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(gg.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=name)


@pytest.mark.parametrize('cin', [39, 23])
def test_padded_train_block_gives_the_unpadded_one(cin):
    """What the card runs for a Cin that is no multiple of 4: the block on
    ``pad_train_inputs``' tensors (x with zero channels, w1 with zero rows)
    and its x and w1 gradients cut back by ``slice_train_grads``, here
    through the plain version, against the block on the unpadded tensors,
    in float64: rtol = atol = 1e-10 (the same products, and exact zeros
    beside them)."""
    a = _inputs(3, 5, 2, 20, cin, 12, 0.3)
    p = _torch_args(a, torch.float64)
    kw = dict(kernel_size=5, dilation=2)
    xp, w1p = port_tcn.pad_train_inputs(p['x'], p['w1'])
    assert xp.shape[-1] == w1p.shape[1] == cin + (-cin) % 4
    assert torch.equal(xp[..., :cin], p['x'])
    assert not xp[..., cin:].any() and not w1p[:, cin:].any()
    rest = [p[k] for k in ('b1', 'w2', 'b2', 'm1', 'm2', 'res')]
    want = port_tcn.fused_temporal_block_train_ref(p['x'], p['w1'], *rest,
                                                   **kw)
    got = port_tcn.fused_temporal_block_train_ref(xp, w1p, *rest, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-10, atol=1e-10)
    g = p['tgt']
    dxp, dw1p, *rest_g = torch.autograd.grad(
        got, [xp, w1p] + [p[k] for k in GRAD_NAMES[2:]], g)
    got_g = (*port_tcn.slice_train_grads(cin, dxp, dw1p), *rest_g)
    want_g = torch.autograd.grad(want, [p[k] for k in GRAD_NAMES], g)
    for name, gg, w in zip(GRAD_NAMES, got_g, want_g):
        assert gg.shape == w.shape, name
        np.testing.assert_allclose(gg.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=name)


@pytest.mark.parametrize('cin', [39, 23])
def test_backward_formula_on_padded_inputs(cin):
    """``_block_bwd_ref`` (the backward kernels' arithmetic) on the padded
    x and w1, dx and dw1 cut back, against autograd of the plain forward on
    the unpadded ones, in float64: rtol = atol = 1e-10."""
    a = _inputs(4, 5, 2, 18, cin, 8, 0.3)
    p = _torch_args(a, torch.float64)
    dil = 4
    out = port_tcn.fused_temporal_block_train_ref(
        p['x'], p['w1'], p['b1'], p['w2'], p['b2'], p['m1'], p['m2'],
        p['res'], kernel_size=5, dilation=dil)
    g = p['tgt']
    want = torch.autograd.grad(out, [p[k] for k in GRAD_NAMES], g)
    with torch.no_grad():
        xp, w1p = port_tcn.pad_train_inputs(p['x'], p['w1'])
        a1 = port_tcn._causal_conv(xp, w1p, p['b1'], dil)
        h = port_tcn._leaky(a1) * p['m1']
        a2 = port_tcn._causal_conv(h, p['w2'], p['b2'], dil)
        dx, dw1, *rest = port_tcn._block_bwd_ref(
            xp, w1p, p['w2'], p['m1'], p['m2'], p['res'], a1, a2, g,
            dilation=dil)
        got = (*port_tcn.slice_train_grads(cin, dx, dw1), *rest)
    for name, gg, w in zip(GRAD_NAMES, got, want):
        assert gg.shape == w.shape, name
        np.testing.assert_allclose(gg.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=name)


def test_padding_leaves_a_multiple_of_4_alone():
    x, w1 = torch.zeros(1, 3, 16), torch.zeros(5, 16, 8)
    xp, w1p = port_tcn.pad_train_inputs(x, w1)
    assert xp is x and w1p is w1


def test_plain_version_gradcheck():
    a = _inputs(2, 3, 1, 6, 4, 4, 0.3)
    p = _torch_args(a, torch.float64)
    # keep every pre-activation away from the kink of leaky at 0
    args = [p[k] for k in ('x', 'w1', 'b1', 'w2', 'b2')]
    assert torch.autograd.gradcheck(
        lambda x, w1, b1, w2, b2, res: port_tcn.fused_temporal_block_train_ref(
            x, w1, b1, w2, b2, p['m1'], p['m2'], res, kernel_size=3,
            dilation=2),
        (*args, p['res']), eps=1e-6, atol=1e-5)


def test_leaky_derivative_at_zero_follows_the_pallas_rule():
    z = torch.zeros(3, requires_grad=True)
    port_tcn._leaky(z).sum().backward()
    assert z.grad.tolist() == [1.0, 1.0, 1.0]
    assert port_tcn._dleaky(torch.tensor([-1.0, 0.0, 2.0])).tolist() == \
        pytest.approx([0.01, 1.0, 1.0])


def test_wgrad_shares_fill_the_card_and_stay_within_the_batch():
    # 5 taps x 12 x 4 tiles: nearly two a SM already
    assert port_tcn._wgrad_shares(16, 5, 768, 256, 132) == 2
    # 5 tiles only: one share per batch row
    assert port_tcn._wgrad_shares(16, 5, 32, 32, 132) == 16
    assert port_tcn._wgrad_shares(3, 5, 32, 32, 132) == 3
    assert port_tcn._wgrad_shares(16, 5, 1024, 1024, 132) == 1


def test_train_wrapper_refuses_a_device_without_kernel():
    x = torch.zeros(1, 4, 8, device='meta')
    w = torch.zeros(3, 8, 8, device='meta')
    b = torch.zeros(8, device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        port_tcn.fused_temporal_block_train(x, w, b, w, b, x, x, x,
                                            kernel_size=3, dilation=1)
