"""The split-TF32 eval TCN block (B1) of the port, on the CPU.

The CUDA kernel (``fvt_tcn_block_tf32x3_forward`` in
``csrc/tcn_block_tf32x3.cu``: conv1, the downsample and conv2 each a
launch of a split-TF32 ``wgmma`` causal conv) runs only on the card; what
it computes is held here: :func:`fused_temporal_block_tf32x3_ref`, the
emulation of its three TF32 products a multiply, against ``fvt_tpu``'s
Pallas block in interpret mode on the same numpy inputs, within the
float32 gate the card holds the kernel to (rtol = atol = 1e-4,
``chip_smoke.py``), up to bert's block 0 (768 -> 256, K*Cin = 3840;
3.0e-6 measured there, on outputs up to 4.0);
the weights' packing; the zero channel pad the wrapper gives Cin = 39;
the shapes the kernel refuses; the packed weights ``TemporalBlock``
keeps; and a whole TemporalConvNet with the emulation in every block
against ``tcn_forward_pallas``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.ops import tcn_pallas as jax_ops
from fvt_tpu_torch.models.from_jax import tcn_state_from_flax
from fvt_tpu_torch.models.tcn import TemporalBlock, TemporalConvNet
from fvt_tpu_torch.ops import conv as conv_ops
from fvt_tpu_torch.ops import tcn as tcn_ops
from test_torch_tcn import _perturbed_tcn_params

GATE = 1e-4
K = 5
NAMES = ('x', 'w1', 'b1', 'w2', 'b2', 'wd', 'bd')


def _inputs(seed, b, t, cin, cout, downsample):
    """Block inputs with weights at the model's init scale (outputs of
    order 1 at any width)."""
    rng = np.random.default_rng(seed)
    arrs = {
        'x': rng.normal(size=(b, t, cin)),
        'w1': rng.normal(size=(K, cin, cout)) * (K * cin) ** -0.5,
        'b1': rng.normal(size=(cout,)) * 0.1,
        'w2': rng.normal(size=(K, cout, cout)) * (K * cout) ** -0.5,
        'b2': rng.normal(size=(cout,)) * 0.1,
        'wd': (rng.normal(size=(cin, cout)) * cin ** -0.5
               if downsample else None),
        'bd': rng.normal(size=(cout,)) * 0.1 if downsample else None,
    }
    return {k: None if v is None else v.astype(np.float32)
            for k, v in arrs.items()}


def _pallas(a, dilation):
    return np.asarray(jax_ops.fused_temporal_block(
        *[None if a[n] is None else jnp.asarray(a[n]) for n in NAMES],
        kernel_size=K, dilation=dilation, interpret=True))


def _torch(a):
    return [None if a[n] is None else torch.from_numpy(a[n]) for n in NAMES]


def _emulated(a, dilation):
    return tcn_ops.fused_temporal_block_tf32x3_ref(
        *_torch(a), kernel_size=K, dilation=dilation)


@pytest.mark.parametrize('b,t,cin,cout,dilation,downsample', [
    (2, 70, 24, 16, 1, True), (2, 70, 16, 16, 1, False),
    (2, 70, 24, 16, 2, True), (2, 70, 16, 16, 2, False),
    (2, 70, 24, 16, 4, True), (2, 70, 16, 16, 4, False),
    (2, 70, 24, 16, 8, True), (2, 70, 16, 16, 8, False),
    (1, 3, 8, 8, 2, False),        # T = 3 under a halo of 8: h's pad
    (1, 2, 20, 8, 8, True),        # every frame in the pad, Cin % 8 = 4
    (1, 24, 768, 256, 1, True),    # bert's block 0: K*Cin = 3840
    (2, 30, 39, 40, 1, True)])     # the mfcc width, Cin % 4 = 3
def test_tf32x3_ref_meets_the_fp32_gate(b, t, cin, cout, dilation,
                                        downsample):
    """The emulation of the kernel against fvt_tpu's Pallas block
    (interpret mode) and the plain version within rtol = atol = 1e-4.
    T = 70 spans two of the kernel's 64-frame tiles; in the short rows
    every output frame needs conv2's causal pad, which is zeros of h, not
    leaky(b1)."""
    a = _inputs(100 * dilation + cin, b, t, cin, cout, downsample)
    got = _emulated(a, dilation)
    assert got.shape == (b, t, cout) and got.dtype == torch.float32
    plain = tcn_ops.fused_temporal_block_ref(*_torch(a), kernel_size=K,
                                             dilation=dilation)
    for want in (_pallas(a, dilation), plain.numpy()):
        np.testing.assert_allclose(got.numpy(), want, rtol=GATE, atol=GATE)


def test_short_row_sees_zeros_of_h():
    """With b1 at 5, leaky(b1) is 5 where h of a zero-padded x would be:
    the emulation, like the kernel (the copy engine's zero fill of h's
    negative frames), must see 0 there, as the Pallas block does."""
    a = _inputs(7, 1, 3, 8, 8, False)
    a['b1'] = a['b1'] + np.float32(5.0)
    got = _emulated(a, 2).numpy()
    np.testing.assert_allclose(got, _pallas(a, 2), rtol=GATE, atol=GATE)
    wrong = dict(a, x=np.concatenate([np.zeros((1, 8, 8), np.float32),
                                      a['x']], axis=1))
    # a pad that took leaky(b1) is far off
    assert np.abs(_emulated(wrong, 2).numpy()[:, 8:] - got).max() > 0.1


@pytest.mark.parametrize('taps,c,co,bn', [(5, 20, 40, 128), (5, 16, 64, 64),
                                          (1, 39, 72, 64)])
def test_pack_taps_layout(taps, c, co, bn):
    """``pack_taps_tf32``: part[t, s, tap, h, n8, n, k] is the split of
    w[tap, 8s + 4h + k, bn*t + 8*n8 + n], zero beyond C and Co; hi + lo
    is w within TF32's second rounding."""
    rng = np.random.default_rng(taps * c + co)
    w = torch.from_numpy(rng.normal(size=(taps, c, co)).astype(np.float32))
    hi, lo = conv_ops.pack_taps_tf32(w, bn)
    tiles, slices = -(-co // bn), -(-c // 8)
    assert hi.shape == lo.shape == (tiles, slices, taps, 2, bn // 8, 8, 4)
    whi, wlo = conv_ops.split_tf32(w)
    for t_ in range(tiles):
        for s in range(slices):
            for h in range(2):
                for k in range(4):
                    ci = 8 * s + 4 * h + k
                    for n8 in range(bn // 8):
                        cols = bn * t_ + 8 * n8 + np.arange(8)
                        for part, want in ((hi, whi), (lo, wlo)):
                            got = part[t_, s, :, h, n8, :, k]
                            ref = torch.zeros(taps, 8)
                            inside = cols < co
                            if ci < c:
                                ref[:, inside] = want[:, ci,
                                                      cols[inside]]
                            assert torch.equal(got, ref)
    np.testing.assert_allclose((hi + lo).sum().item(), w.sum().item(),
                               rtol=1e-5)


def test_pack_block_weights_column_tiles():
    """The block packs w1, w2 and the downsample (one tap) at column tiles
    of 64 outputs, a Cout below 64 in one tile with zero columns."""
    bn = tcn_ops.COLUMN_TILE
    assert bn == 64
    for cout in (8, 32, 64, 256):
        a = _inputs(cout, 1, 4, 12, cout, True)
        w1, _, w2, _, wd, _ = _torch(a)[1:]
        p1, p2, pd = tcn_ops.pack_block_weights(w1, w2, wd)
        tiles = -(-cout // bn)
        assert p1[0].shape == (tiles, 2, K, 2, bn // 8, 8, 4)
        assert p2[1].shape == (tiles, cout // 8, K, 2, bn // 8, 8, 4)
        assert pd[0].shape == (tiles, 2, 1, 2, bn // 8, 8, 4)
        assert torch.equal(pd[0], conv_ops.pack_taps_tf32(wd[None], bn)[0])
    assert tcn_ops.pack_block_weights(w1, w2)[2] is None


def test_channel_pad_gives_the_plain_output():
    """Cin = 39: the wrapper's zero channels (``pad_channels``) leave x's
    channels bit for bit and add exact zeros; the packed w1 and wd of 39
    rows are bit for bit those of the zero-padded 40-row weights, so the
    kernel sums the same products; and the emulation on the padded x with
    the padded weights gives the plain output of the unpadded block."""
    a = _inputs(39, 2, 30, 39, 40, True)
    x, w1, b1, w2, b2, wd, bd = _torch(a)
    xp = tcn_ops.pad_channels(x)
    assert xp.shape == (2, 30, 40)
    assert torch.equal(xp[..., :39], x)
    assert torch.equal(xp[..., 39:], torch.zeros(2, 30, 1))
    assert tcn_ops.pad_channels(xp) is xp
    w1p = torch.nn.functional.pad(w1, (0, 0, 0, 1))
    wdp = torch.nn.functional.pad(wd, (0, 0, 0, 1))
    for got, want in zip(tcn_ops.pack_block_weights(w1, w2, wd),
                         tcn_ops.pack_block_weights(w1p, w2, wdp)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    padded = tcn_ops.fused_temporal_block_tf32x3_ref(
        xp, w1p, b1, w2, b2, wdp, bd, kernel_size=K, dilation=1)
    plain = tcn_ops.fused_temporal_block_ref(x, w1, b1, w2, b2, wd, bd,
                                             kernel_size=K, dilation=1)
    np.testing.assert_allclose(padded.numpy(), plain.numpy(), rtol=GATE,
                               atol=GATE)
    np.testing.assert_allclose(padded.numpy(), _pallas(a, 1), rtol=GATE,
                               atol=GATE)


@pytest.mark.parametrize('cin,cout,dilation', [(16, 12, 1), (8, 4, 1),
                                               (20, 20, 100)])
def test_refused_shapes_raise(cin, cout, dilation):
    """Cout not a multiple of 8 (at dilation 100 too, whose halo the
    kernel now takes in two boxes): the shape check raises with the shape
    in the message, and so does the wrapper for a tensor off the CPU (a meta
    tensor here: the check comes before the launch)."""
    with pytest.raises(ValueError, match=f'Cout={cout}'):
        tcn_ops.check_tf32x3_shape(cin, cout, K, dilation)
    a = _inputs(1, 1, 4, cin, cout, cin != cout)
    meta = [None if t is None else t.to('meta') for t in _torch(a)]
    with pytest.raises(ValueError, match=f'dilation={dilation}'):
        tcn_ops.fused_temporal_block(*meta, kernel_size=K,
                                     dilation=dilation)


@pytest.mark.parametrize('cin,cout,dilation', [(64, 64, 49), (24, 24, 100)])
def test_long_halo_shapes_are_taken(cin, cout, dilation):
    """64 + (K-1)*dilation beyond one TMA box of 256 rows (refused before
    the taps came in groups): the shape check takes it, the kernel's plan
    has more than one box (two at 49, three at 100), and the emulation of the grouped sums meets the gate
    against the Pallas block (T = 260 frames, beyond the halo)."""
    tcn_ops.check_tf32x3_shape(cin, cout, K, dilation)
    g, groups = tcn_ops.tap_groups(K, dilation)
    assert groups == (2 if dilation == 49 else 3)
    assert tcn_ops.ROW_TILE + (g - 1) * dilation <= 256
    a = _inputs(dilation, 1, 260, cin, cout, cin != cout)
    np.testing.assert_allclose(_emulated(a, dilation).numpy(),
                               _pallas(a, dilation), rtol=GATE, atol=GATE)


def test_largest_halo_and_taps_are_taken():
    """64 + 4*48 = 256 rows, one whole box, and nine taps: one group;
    ten taps, beyond the kernel's instantiations, two groups of five; a
    halo of 2^30 frames, whose TMA coordinates would overflow, raises."""
    tcn_ops.check_tf32x3_shape(64, 64, K, 48)
    assert tcn_ops.tap_groups(K, 48) == (K, 1)
    tcn_ops.check_tf32x3_shape(39, 8, K, 1)
    tcn_ops.check_tf32x3_shape(16, 16, 9, 1)
    assert tcn_ops.tap_groups(9, 1) == (9, 1)
    tcn_ops.check_tf32x3_shape(16, 16, 10, 1)
    assert tcn_ops.tap_groups(10, 1) == (5, 2)
    with pytest.raises(ValueError, match='K=2'):
        tcn_ops.check_tf32x3_shape(16, 16, 2, 2 ** 30)


@pytest.mark.parametrize('k', [5, 9, 10, 11, 17])
@pytest.mark.parametrize('dilation', [1, 8, 48, 64, 100])
def test_tap_groups_cover_the_taps_in_boxes(k, dilation):
    """The plan of the grouped kernel: G at most nine taps (the
    instantiations), each group's box ``64 + (G-1)*dilation`` rows within
    one TMA box of 256, every tap in exactly one group and the zero taps
    (``pad_taps``) only after the last real one; one group, G = K, wherever
    K <= 9 and the whole halo fits one box (the model's blocks: K = 5,
    dilation up to 16)."""
    g, groups = tcn_ops.tap_groups(k, dilation)
    assert 1 <= g <= tcn_ops.MAX_TAPS
    assert tcn_ops.ROW_TILE + (g - 1) * dilation <= tcn_ops.MAX_BOX
    taps = [i * g + j for i in range(groups) for j in range(g)]
    assert taps == list(range(g * groups)) and g * groups >= k
    assert g * (groups - 1) < k  # the last group holds a real tap
    if k <= 9 and tcn_ops.ROW_TILE + (k - 1) * dilation <= 256:
        assert (g, groups) == (k, 1)
    # fewer groups would need a longer box or more taps than nine
    if groups > 1:
        wider = -(-k // (groups - 1))
        assert wider > tcn_ops.MAX_TAPS or \
            tcn_ops.ROW_TILE + (wider - 1) * dilation > tcn_ops.MAX_BOX
    w = torch.arange(1.0, k + 1).reshape(k, 1, 1)
    padded = tcn_ops.pad_taps(w, dilation)
    assert padded.shape[0] == g * groups
    assert torch.equal(padded[:k], w) and not padded[k:].any()
    assert (tcn_ops.pad_taps(w, dilation) is w) == (g * groups == k)


@pytest.mark.parametrize('ks,dilation,t,downsample', [
    (11, 8, 150, True), (5, 64, 300, False), (17, 16, 300, True)])
def test_grouped_taps_meet_the_fp32_gate(ks, dilation, t, downsample):
    """K = 11 at dilation 8 (two groups of six, one zero tap), K = 5 at
    dilation 64 (a halo of 256 rows: two groups of three) and K = 17 at 16
    (two of nine): the emulation, its sums grouped as the kernel's steps,
    against fvt_tpu's Pallas block in interpret mode and the plain version
    within rtol = atol = 1e-4, on weights at the model's init scale."""
    rng = np.random.default_rng(ks * dilation)
    cin, cout = 24, 16
    a = {'x': rng.normal(size=(2, t, cin)),
         'w1': rng.normal(size=(ks, cin, cout)) * (ks * cin) ** -0.5,
         'b1': rng.normal(size=(cout,)) * 0.1,
         'w2': rng.normal(size=(ks, cout, cout)) * (ks * cout) ** -0.5,
         'b2': rng.normal(size=(cout,)) * 0.1,
         'wd': rng.normal(size=(cin, cout)) * cin ** -0.5,
         'bd': rng.normal(size=(cout,)) * 0.1}
    if not downsample:
        a['x'] = a['x'][..., :cout]
        a['w1'] = a['w1'][:, :cout] * (cin / cout) ** 0.5
        a['wd'] = a['bd'] = None
    a = {k: None if v is None else v.astype(np.float32)
         for k, v in a.items()}
    args = _torch(a)
    got = tcn_ops.fused_temporal_block_tf32x3_ref(
        *args, kernel_size=ks, dilation=dilation)
    plain = tcn_ops.fused_temporal_block_ref(*args, kernel_size=ks,
                                             dilation=dilation)
    want = np.asarray(jax_ops.fused_temporal_block(
        *[None if a[n] is None else jnp.asarray(a[n]) for n in NAMES],
        kernel_size=ks, dilation=dilation, interpret=True))
    for ref in (want, plain.numpy()):
        np.testing.assert_allclose(got.numpy(), ref, rtol=GATE, atol=GATE)


def test_pack_block_weights_pads_the_last_group():
    """At K = 11 and dilation 8 the packed convs carry 12 taps (two groups
    of six), the twelfth zero, and are the packing of the zero-padded
    weights; the downsample keeps its one tap."""
    a = _inputs(11, 1, 4, 12, 16, True)
    rng = np.random.default_rng(0)
    w1 = torch.from_numpy(rng.normal(size=(11, 12, 16)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(11, 16, 16)).astype(np.float32))
    wd = _torch(a)[5]
    p1, p2, pd = tcn_ops.pack_block_weights(w1, w2, wd, dilation=8)
    assert p1[0].shape[2] == p2[1].shape[2] == 12 and pd[0].shape[2] == 1
    for part in (*p1, *p2):
        assert not part[:, :, 11].any()
    zero = torch.zeros(1, 12, 16)
    assert torch.equal(p1[0], conv_ops.pack_taps_tf32(
        torch.cat([w1, zero]), tcn_ops.COLUMN_TILE)[0])


def test_block_keeps_its_packed_weights():
    """``eval_weights`` derives the split packing once and keeps it; an
    in-place change of a parameter makes it derive them again."""
    blk = TemporalBlock(12, 16, K, dilation=2)
    blk.reset_parameters(torch.Generator().manual_seed(0))
    first = blk.eval_weights()
    assert blk.eval_weights() is first
    want = blk.kernel_weights()
    for p, w in zip(first['packed'], tcn_ops.pack_block_weights(
            want['w1'], want['w2'], want['wd'])):
        assert all(torch.equal(g, v) for g, v in zip(p, w))
    assert not any(t.requires_grad for t in first['packed'][0])
    with torch.no_grad():
        blk.conv2.weight_g.mul_(2.0)
    again = blk.eval_weights()
    assert again is not first
    assert torch.equal(again['w2'], 2.0 * first['w2'])


def test_tcn_with_the_emulation_matches_pallas():
    """A TemporalConvNet at the mfcc input width (Cin = 39) with the
    emulation in every block, on weights carried over from flax, against
    ``tcn_forward_pallas`` within the gate."""
    channels = [32, 32, 16, 16]
    cin = 39
    _, params = _perturbed_tcn_params(channels, cin, seed=4)
    x = np.random.default_rng(5).normal(size=(2, 70, cin)).astype(
        np.float32)
    want = np.asarray(jax_ops.tcn_forward_pallas(
        jnp.asarray(x), params, channels, kernel_size=K, interpret=True))
    net = TemporalConvNet(cin, channels, K)
    net.load_state_dict(tcn_state_from_flax(params), strict=True)
    h = torch.from_numpy(x)
    with torch.inference_mode():
        for i, blk in enumerate(net.network):
            w = blk.eval_weights()
            h = tcn_ops.fused_temporal_block_tf32x3_ref(
                h, w['w1'], w['b1'], w['w2'], w['b2'], w['wd'], w['bd'],
                kernel_size=K, dilation=2 ** i)
    np.testing.assert_allclose(h.numpy(), want, rtol=GATE, atol=GATE)
