"""The split-TF32 train-mode TCN block (B3a forward, B3b backward) of the
port, on the CPU.

The CUDA kernels (``csrc/tcn_block_train_tf32x3.cu``: the forward's pack,
conv1 and conv2 launches; the backward's elementwise pass, pack,
anti-causal convs for d_a1 and dx, weight gradients and bias sums) run
only on the card; what they compute is held here:
``fused_temporal_block_train_tf32x3_ref`` and ``_block_bwd_tf32x3_ref``,
the emulations of their three TF32 products a multiply, against
``fvt_tpu``'s Pallas block in interpret mode on the same numpy inputs
(its gradients by ``jax.vjp`` through its custom VJP) within the
tolerances of ``tests/test_torch_tcn_train.py`` (output rtol = atol =
1e-5, gradients 2e-4), and against the float64 plain version within the
gate the card holds the kernels to (``chip_smoke.py``: 1e-4, weight and
bias gradients 1e-4 of their largest value); the weights' packing in both
directions; the anti-causal convs' boxes; the weight gradient's batch
shares and frame slices; and the wrapper's backward skipping dx where x
needs no gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.ops.tcn_pallas import fused_temporal_block_train as jax_block
from fvt_tpu_torch.ops import conv as conv_ops
from fvt_tpu_torch.ops import tcn as tcn_ops

GRAD_NAMES = ('x', 'w1', 'b1', 'w2', 'b2', 'res')
GATE = 1e-4


def _inputs(seed, ks, b, t, cin, cout, dropout):
    """Block inputs with weights at the model's init scale (outputs of
    order 1 at any width), masks pre-scaled, a cotangent."""
    rng = np.random.default_rng(seed)
    a = {'x': rng.normal(size=(b, t, cin)),
         'w1': rng.normal(size=(ks, cin, cout)) * (ks * cin) ** -0.5,
         'b1': rng.normal(size=(cout,)) * 0.1,
         'w2': rng.normal(size=(ks, cout, cout)) * (ks * cout) ** -0.5,
         'b2': rng.normal(size=(cout,)) * 0.1,
         'res': rng.normal(size=(b, t, cout)),
         'g': rng.normal(size=(b, t, cout))}
    keep = 1.0 - dropout
    for m in ('m1', 'm2'):
        a[m] = ((rng.random((b, t, cout)) < keep) / keep if dropout
                else np.ones((b, t, cout)))
    return {k: v.astype(np.float32) for k, v in a.items()}


def _torch(a, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in a.items()}


def _emulated(a, ks, dil, shares=(1, 1)):
    """The kernels' forward output and six gradients, emulated, on the
    tensors the card runs (x and w1 on zero channels up to a multiple of
    4), dx and dw1 cut back."""
    p = _torch(a)
    cin = p['x'].shape[-1]
    x, w1 = tcn_ops.pad_train_inputs(p['x'], p['w1'])
    args = (x, w1, p['b1'], p['w2'], p['b2'], p['m1'], p['m2'], p['res'])
    a1, h, a2, out = tcn_ops.train_forward_tf32x3_ref(
        *args, kernel_size=ks, dilation=dil)
    assert torch.equal(out, tcn_ops.fused_temporal_block_train_tf32x3_ref(
        *args, kernel_size=ks, dilation=dil))
    dx, dw1, db1, dw2, db2, dres = tcn_ops._block_bwd_tf32x3_ref(
        x, w1, p['w2'], p['m1'], p['m2'], p['res'], a1, h, a2, p['g'],
        dilation=dil, shares=shares)
    dx, dw1 = tcn_ops.slice_train_grads(cin, dx, dw1)
    return out, (dx, dw1, db1, dw2, db2, dres)


# T = 40 spans two 32-frame slices of the weight gradient; T = 3 lies
# under a halo of (K-1)*d = 16 frames; Cin = 39 runs on zero channels
@pytest.mark.parametrize('ks,dil,t,cin,cout,dropout', [
    (3, 1, 16, 8, 16, 0.0),
    (3, 4, 40, 8, 16, 0.3),
    (5, 8, 40, 12, 8, 0.3),
    (5, 4, 3, 8, 16, 0.3),
    (5, 1, 40, 39, 32, 0.3),
])
def test_emulation_matches_pallas(ks, dil, t, cin, cout, dropout):
    """The emulated forward against ``fused_temporal_block_train`` in
    interpret mode within rtol = atol = 1e-5, and the emulated backward's
    six gradients against ``jax.vjp`` of it within 2e-4: the tolerances
    of ``tests/test_torch_tcn_train.py``, which the split-TF32 products
    (2^-21 of a product) meet with room at the init scale."""
    a = _inputs(10 * ks + dil, ks, 2, t, cin, cout, dropout)
    j = {k: jnp.asarray(v) for k, v in a.items()}

    def jax_out(x, w1, b1, w2, b2, res):
        return jax_block(x, w1, b1, w2, b2, j['m1'], j['m2'], res,
                         kernel_size=ks, dilation=dil, interpret=True)

    want, vjp = jax.vjp(jax_out, *(j[k] for k in GRAD_NAMES))
    want_grads = vjp(j['g'])
    got, got_grads = _emulated(a, ks, dil)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for name, g, w in zip(GRAD_NAMES, got_grads, want_grads):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize('ks,dil,b,t,cin,cout,shares', [
    (5, 2, 3, 70, 64, 64, (2, 3)),
    (5, 1, 2, 40, 768, 256, (2, 1)),   # bert's block 0: K*Cin = 3840
    (11, 8, 2, 100, 24, 16, (1, 2)),   # two groups of six taps
])
def test_emulation_meets_the_chip_gate(ks, dil, b, t, cin, cout, shares):
    """The emulation against the float64 plain version (autograd of
    ``fused_temporal_block_train_ref``) within the gate ``chip_smoke.py``
    holds the kernels to: forward, dx and dres within rtol = atol = 1e-4,
    weight and bias gradients within 1e-4 of their largest value; in
    batch shares as the card cuts them at these widths or more."""
    a = _inputs(ks * dil + cin, ks, b, t, cin, cout, 0.1)
    got, got_grads = _emulated(a, ks, dil, shares)
    p = _torch(a, torch.float64)
    for k in GRAD_NAMES:
        p[k].requires_grad_(True)
    want = tcn_ops.fused_temporal_block_train_ref(
        p['x'], p['w1'], p['b1'], p['w2'], p['b2'], p['m1'], p['m2'],
        p['res'], kernel_size=ks, dilation=dil)
    want_grads = torch.autograd.grad(want, [p[k] for k in GRAD_NAMES],
                                     p['g'])
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                               rtol=GATE, atol=GATE)
    for name, g, w in zip(GRAD_NAMES, got_grads, want_grads):
        w = w.numpy()
        if name in ('x', 'res'):
            np.testing.assert_allclose(g.numpy(), w, rtol=GATE, atol=GATE,
                                       err_msg=name)
        else:
            assert np.abs(g.numpy() - w).max() <= GATE * np.abs(w).max(), \
                name


@pytest.mark.parametrize('transposed', [False, True])
@pytest.mark.parametrize('ks,dil,cin,cout', [(5, 1, 20, 72), (11, 8, 12, 8),
                                             (3, 2, 40, 32)])
def test_pack_train_weights_layout(ks, dil, cin, cout, transposed):
    """What the pack launch writes: part[t, s, tap, h, n8, n, k] is the
    split of W_tap[c, o], c = 8s + 4h + k, o = 64t + 8*n8 + n, with W_tap
    = w[tap] forward and w[K-1-tap]^T transposed, zero beyond the conv's
    inputs, outputs and K taps (K = 11 at d = 8 packs two groups of six);
    w1 (K, Cin, Cout) and w2 (K, Cout, Cout), each part in the shape of
    ``train_pack_shape`` and of its part of the scratch ``train_scratch``
    lays out."""
    rng = np.random.default_rng(ks + cin)
    w1 = torch.from_numpy(rng.normal(size=(ks, cin, cout)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(ks, cout, cout)).astype(
        np.float32))
    packed = tcn_ops.pack_train_weights(w1, w2, dilation=dil,
                                        transposed=transposed)
    layout, floats = tcn_ops.train_scratch(2, 9, cin, cout, ks, dil,
                                           backward=transposed)
    assert floats >= max(o + np.prod(s) for o, s in layout.values())
    g, groups = tcn_ops.tap_groups(ks, dil)
    for w, (hi, lo), name in zip((w1, w2), packed, ('w1', 'w2')):
        c_in, c_out = (w.shape[2], w.shape[1]) if transposed else \
            (w.shape[1], w.shape[2])
        shape = tcn_ops.train_pack_shape(c_in, c_out, ks, dil)
        assert hi.shape == lo.shape == shape == layout[name + '_hi'][1] \
            == layout[name + '_lo'][1]
        assert layout[name + '_lo'][0] - layout[name + '_hi'][0] \
            == hi.numel()
        assert shape[2] == g * groups
        whi, wlo = conv_ops.split_tf32(w)
        want_hi = torch.zeros(shape)
        want_lo = torch.zeros(shape)
        for tap in range(ks):
            src = ks - 1 - tap if transposed else tap
            for c in range(c_in):
                for o in range(c_out):
                    at = (o // 64, c // 8, tap, c % 8 // 4, o % 64 // 8,
                          o % 8, c % 4)
                    pick = (src, o, c) if transposed else (src, c, o)
                    want_hi[at] = whi[pick]
                    want_lo[at] = wlo[pick]
        assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('ks,dil', [(5, 1), (5, 8), (5, 64), (11, 8),
                                    (17, 16), (9, 24)])
def test_tap_boxes_read_the_taps_frames(ks, dil, causal):
    """The conv kernel's boxes (``tap_boxes``): each within one TMA box of
    256 rows, every real tap in exactly one group, and kernel tap j of a
    group reading, for output frame s of the tile, the frame the conv
    needs: ``s - (K-1)*d + k*d`` causally, and for the anti-causal conv
    the frame ``s + (K-1)*d - k*d`` of the forward tap k = K-1-k' whose
    transpose is packed tap k' (``transpose_taps``)."""
    boxes = tcn_ops.tap_boxes(ks, dil, causal=causal)
    pad = (ks - 1) * dil
    seen = []
    for i, (start, rows, taps) in enumerate(boxes):
        assert rows <= tcn_ops.MAX_BOX and taps
        g = tcn_ops.tap_groups(ks, dil)[0]
        for j, tap in enumerate(taps):
            assert tap == i * g + j
            seen.append(tap)
            for s in (0, tcn_ops.ROW_TILE - 1):
                frame = start + j * dil + s
                assert j * dil + s < rows  # inside the box
                if causal:
                    assert frame == s - pad + tap * dil
                else:
                    k = ks - 1 - tap
                    assert frame == s + pad - k * dil
    assert seen == list(range(ks))


@pytest.mark.parametrize('ks,dil,t', [(5, 1, 70), (5, 8, 20), (11, 8, 90),
                                      (5, 64, 300)])
def test_anti_causal_conv_is_the_input_gradient(ks, dil, t):
    """The anti-causal conv of the emulation (``_split_conv`` with
    ``causal=False`` on ``transpose_taps``, its taps in the groups of
    ``tap_groups``) against the input gradient in the gather form of
    ``_block_bwd_ref`` in float64, ``d_in[s] = sum_k d_out[s + (K-1)*d -
    k*d] . w[k]^T``, within 1e-5; and both against autograd of the causal
    conv."""
    rng = np.random.default_rng(ks * dil + t)
    cin, cout = 12, 16
    d_out = rng.normal(size=(2, t, cout)).astype(np.float32)
    w = (rng.normal(size=(ks, cin, cout)) * (ks * cin) ** -0.5).astype(
        np.float32)
    got = tcn_ops._split_conv(torch.from_numpy(d_out),
                              tcn_ops.transpose_taps(torch.from_numpy(w)),
                              None, dil, causal=False)
    d64, w64 = torch.from_numpy(d_out).double(), torch.from_numpy(w).double()
    pad = (ks - 1) * dil
    want = sum(tcn_ops._shift_back(d64, pad - k * dil) @ w64[k].t()
               for k in range(ks))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    x = torch.zeros(2, t, cin, dtype=torch.float64, requires_grad=True)
    y = tcn_ops._causal_conv(x, w64, torch.zeros(cout, dtype=torch.float64),
                             dil)
    (auto,) = torch.autograd.grad(y, x, d64)
    np.testing.assert_allclose(want.numpy(), auto.numpy(), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize('b,shares', [(3, 1), (3, 2), (3, 3), (16, 5)])
def test_wgrad_slices_and_shares(b, shares):
    """The weight gradient as the kernel cuts it (``_split_wgrad``): batch
    shares of rows ``B*s//S`` up to ``B*(s+1)//S`` (each at least one row,
    together the batch once), 32-frame slices from the first one whose
    act frames are not all in the causal pad; the cut sums agree with the
    uncut float64 sum within the gate, and the first slice of each tap
    starts where its act rows leave the pad."""
    rows = [list(range(b * s // shares, b * (s + 1) // shares))
            for s in range(shares)]
    assert all(rows) and sum(rows, []) == list(range(b))
    ks, dil, t = 5, 8, 70
    rng = np.random.default_rng(b * shares)
    act = torch.from_numpy(rng.normal(size=(b, t, 24)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(b, t, 16)).astype(np.float32))
    got = tcn_ops._split_wgrad(act, d, ks, dil, shares)
    pad = (ks - 1) * dil
    want = torch.stack([torch.einsum(
        'btc,bto->co', tcn_ops._shift_forward(act.double(), pad - k * dil),
        d.double()) for k in range(ks)])
    assert np.abs(got.numpy() - want.numpy()).max() <= \
        GATE * want.abs().max().item()
    for k in range(ks):
        shift = pad - k * dil
        first = shift // tcn_ops.WGRAD_ROWS * tcn_ops.WGRAD_ROWS
        assert first <= shift < first + tcn_ops.WGRAD_ROWS
        # frames before the first slice meet only the pad
        assert not tcn_ops._shift_forward(act, shift)[:, :first].any()


@pytest.mark.parametrize('cin', [16, 39])
def test_backward_skips_dx_where_x_needs_no_grad(cin):
    """``train_backward`` (the wrapper's backward; the plain formula on
    the CPU) returns None for dx when it is not needed, and the same dw1
    and other gradients as with dx; and the autograd Function on the
    CPU, x without a gradient (a TCN's first block, on the features),
    gives the weight gradients of autograd of the plain version."""
    ks, dil = 5, 2
    a = _inputs(cin, ks, 2, 30, cin, 16, 0.3)
    p = _torch(a)
    x, w1 = tcn_ops.pad_train_inputs(p['x'], p['w1'])
    args = (x, w1, p['b1'], p['w2'], p['b2'], p['m1'], p['m2'], p['res'])
    saved, _ = tcn_ops.train_forward(*args, kernel_size=ks, dilation=dil)
    inputs = (x, w1, p['w2'], p['m1'], p['m2'], p['res'])
    kw = dict(kernel_size=ks, dilation=dil)
    without = tcn_ops.train_backward(inputs, saved, p['g'], need_dx=False,
                                     **kw)
    with_dx = tcn_ops.train_backward(inputs, saved, p['g'], **kw)
    assert without[0] is None and with_dx[0].shape == x.shape
    for got, want in zip(without[1:], with_dx[1:]):
        assert torch.equal(got, want)

    leaves = [p[k].requires_grad_(True) for k in GRAD_NAMES[1:]]
    fused = tcn_ops._FusedTemporalBlockTrain.apply(
        p['x'], *leaves[:4], p['m1'], p['m2'], leaves[4], ks, dil)
    plain = tcn_ops.fused_temporal_block_train_ref(
        p['x'], *leaves[:4], p['m1'], p['m2'], leaves[4], **kw)
    np.testing.assert_allclose(fused.detach().numpy(),
                               plain.detach().numpy(), rtol=1e-6, atol=1e-6)
    got = torch.autograd.grad(fused, leaves, p['g'])
    want = torch.autograd.grad(plain, leaves, p['g'])
    for name, g, w in zip(GRAD_NAMES[1:], got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert tcn_ops.fused_temporal_block_train.launches_fwd == 0


def test_simt_wrapper_runs_the_plain_version_on_the_cpu():
    """The CUDA-core train kernels' wrapper, kept for measurements, runs
    the plain version on the CPU and refuses a device without a kernel."""
    a = _torch(_inputs(3, 3, 1, 9, 8, 8, 0.3))
    args = [a[k] for k in ('x', 'w1', 'b1', 'w2', 'b2', 'm1', 'm2', 'res')]
    kw = dict(kernel_size=3, dilation=2)
    assert torch.equal(tcn_ops.fused_temporal_block_train_simt(*args, **kw),
                       tcn_ops.fused_temporal_block_train_ref(*args, **kw))
    meta = [v.to('meta') for v in args]
    with pytest.raises(ValueError, match='no kernel'):
        tcn_ops.fused_temporal_block_train_simt(*meta, **kw)
