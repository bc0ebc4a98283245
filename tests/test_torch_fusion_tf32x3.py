"""The split-TF32 fusion block (B2) of the port, on the CPU.

The CUDA kernel (``fvt_fusion_tf32x3_forward`` in
``csrc/fusion_tf32x3.cu``: qkv and ``o_proj`` as split-TF32 ``wgmma``
products, the attention in registers, the LayerNorm in the epilogue, one
launch for 1 to 7 modalities) runs only on the card; what it computes is
held here: :func:`fused_multimodal_fusion_tf32x3_ref`, the emulation of
its three TF32 products a multiply, against ``fvt_tpu``'s Pallas kernel in
interpret mode on the same numpy inputs at 1, 2, 3, 5 and 7 modalities and
a head size that is padded (E = 36, H = 3), within the tolerance of
``tests/test_torch_fusion.py`` (fp32 on both sides, summed in another
order: rtol 2e-4, atol 2e-5), and at E = 64 (two slices a head; E*M =
320 at five modalities) and the wide E*M whose cat the kernel passes
through a device workspace (576 at E = 96, H = 3 over six modalities;
640 at E = 128 over five); the packed layout, and the kernel's steps over
it (64-frame tiles, heads in slices of 16 dims, o in chunks of 32)
replayed in plain PyTorch against the plain version; the shapes the
kernel refuses; the weights ``MultimodalTransformerEncoder`` keeps; and
the encoder through the bridge against flax's.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fvt_tpu.models.fusion import MultimodalTransformerEncoder as FlaxMTE
from fvt_tpu.ops.fusion_pallas import fused_multimodal_fusion as pallas
from fvt_tpu_torch.config import model_config as MC
from fvt_tpu_torch.models.fusion import MultimodalTransformerEncoder
from fvt_tpu_torch.models.from_jax import fusion_state_from_flax
from fvt_tpu_torch.ops import fusion as ops
from fvt_tpu_torch.ops.conv import split_tf32

RTOL, ATOL = 2e-4, 2e-5
MAIN = ('video', 'vggish', 'bert')
# (modalities, modal_dim, num_heads): 1, 2, 3, 5 and 7 modalities at the
# model's E = 32, H = 2; E = 36, H = 3 (hd = 12, padded to a slice of 16);
# E = 64, H = 2 (hd = 32: two slices a head, the kernel's two passes);
# E = 64 at five modalities (E*M = 320: cat through the workspace, o in
# two groups, the LayerNorm through y); E*M = 576 (E = 96, H = 3 at six:
# two slices a head) and 640 (E = 128 at five: three groups of o)
FIVE = ('bert', 'vggish', 'mfcc', 'egemaps', 'cnn_res50')
SEVEN = ('video', 'bert', 'cnn_res50', 'mfcc', 'vggish', 'logmel',
         'egemaps')
CASES = [(('video',), 32, 2), (('vggish', 'bert'), 32, 2), (MAIN, 32, 2),
         (FIVE, 32, 2), (SEVEN, 32, 2),
         (MAIN, 36, 3), (MAIN, 64, 2), (FIVE, 64, 2), (SEVEN[:6], 96, 3),
         (FIVE, 128, 2)]
IDS = ['M1', 'M2', 'M3', 'M5', 'M7', 'E36H3', 'E64H2', 'M5E64', 'M6E96H3',
       'M5E128']


def _params(mods, dims, e, rng):
    """A fusion param tree in fvt_tpu's layout, every leaf random (the
    init's zero biases and unit LayerNorm would hide a dropped term)."""
    em = e * len(mods)

    def dense(cin, cout):
        return {'dense': {
            'kernel': rng.normal(size=(cin, cout)).astype(np.float32)
            * cin ** -0.5,
            'bias': rng.normal(size=(cout,)).astype(np.float32) * 0.1}}
    attn = {f'qkv_{m}': dense(dims[m], 3 * e) for m in mods}
    attn['o_proj'] = dense(em, em)
    norm = {'scale': rng.uniform(0.5, 1.5, em).astype(np.float32),
            'bias': rng.normal(size=(em,)).astype(np.float32) * 0.1}
    return {'self_attn': attn, 'norm1': norm}


def _case(mods, e, seed, b=2, t=24):
    rng = np.random.default_rng(seed)
    dims = {m: MC.ENCODER_DIM[m] for m in mods}
    params = _params(mods, dims, e, rng)
    x = {m: rng.normal(size=(b, t, dims[m])).astype(np.float32)
         for m in mods}
    return params, x


def _torch_args(params, x, mods):
    attn = params['self_attn']
    t = torch.from_numpy
    return ([t(x[m]) for m in mods],
            [t(attn[f'qkv_{m}']['dense']['kernel']) for m in mods],
            [t(attn[f'qkv_{m}']['dense']['bias']) for m in mods],
            t(attn['o_proj']['dense']['kernel']),
            t(attn['o_proj']['dense']['bias']),
            t(params['norm1']['scale']), t(params['norm1']['bias']))


@pytest.mark.parametrize('mods,e,heads', CASES, ids=IDS)
def test_tf32x3_emulation_matches_pallas(mods, e, heads):
    params, x = _case(mods, e, seed=len(mods) + e)
    want = pallas({m: jnp.asarray(v) for m, v in x.items()}, params, mods,
                  e, heads, time_tile=8, interpret=True)
    got = ops.fused_multimodal_fusion_tf32x3_ref(
        *_torch_args(params, x, mods), modal_dim=e, num_heads=heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _unpack(part, c, n):
    """A packed part ``(..., slices, 2, n/8, 8, 4)`` back to ``(..., C,
    n)`` by the layout's formula: ``[s, chunk, n8, n, k]`` holds
    ``w[8*s + 4*chunk + k, 8*n8 + n]``."""
    lead = part.shape[:-5]
    w = part.permute(*range(len(lead)), -5, -4, -1, -3, -2)
    return w.reshape(*lead, -1, n)[..., :c, :]


@pytest.mark.parametrize('mods,e,heads', CASES, ids=IDS)
def test_packed_layout(mods, e, heads):
    """WqkvT per (head, slice of 16 dims): q, k and v's columns of the
    head at 0, 16 and 32, zeros at the dims beyond hd and the channels
    beyond C_m; hi and lo the two parts of ``split_tf32``, so hi + lo is
    the weight within lo's rounding; the biases in the same columns; Wo
    per chunk of 32 columns, zeros beyond E*M."""
    params, x = _case(mods, e, seed=3)
    xs, wqkv, bqkv, wo, _, _, _ = _torch_args(params, x, mods)
    packed = ops.pack_fusion_weights(wqkv, bqkv, wo, modal_dim=e,
                                     num_heads=heads)
    hd = e // heads
    s = -(-hd // ops.HEAD_SLICE)
    for w, bias, (hi, lo), b_packed in zip(wqkv, bqkv, packed['wqkv'],
                                           packed['bqkv']):
        c = w.shape[0]
        assert hi.shape == lo.shape == (heads * s, 4 * -(-c // 32), 2, 6,
                                        8, 4)
        want = torch.zeros(heads * s, c, 48)
        want_b = torch.zeros(heads * s, 48)
        for h in range(heads):
            for ds in range(s):
                for part in range(3):
                    for t in range(ops.HEAD_SLICE):
                        d = ops.HEAD_SLICE * ds + t
                        if d < hd:
                            col = h * 3 * hd + part * hd + d
                            want[h * s + ds, :, 16 * part + t] = w[:, col]
                            want_b[h * s + ds, 16 * part + t] = bias[col]
        want_hi, want_lo = split_tf32(want)
        assert torch.equal(_unpack(hi, c, 48), want_hi)
        assert torch.equal(_unpack(lo, c, 48), want_lo)
        np.testing.assert_allclose(_unpack(hi + lo, c, 48), want,
                                   rtol=2.0 ** -20, atol=0)
        assert torch.equal(b_packed, want_b)
    em = e * len(mods)
    hi, lo = packed['wo']
    chunks = -(-em // ops.O_CHUNK)
    assert hi.shape == (chunks, 4 * chunks, 2, 4, 8, 4)
    got = torch.cat([_unpack(p, 32 * chunks, ops.O_CHUNK) for p in hi],
                    dim=1)
    assert torch.equal(got[:em, :em], split_tf32(wo)[0])
    assert not got[em:].any() and not got[:, em:].any()


def _kernel_steps(xs, packed, bo, ln_scale, ln_bias, e, heads):
    """The kernel's steps over the packed weights, in plain PyTorch: per
    tile of 64 frames and head, per slice of 16 dims a (64 x 48) product a
    modality over steps of 32 channels (two passes where hd > 16: the
    logits summed over the slices, then the values), cat at column (h*M +
    m1)*hd + d, o in chunks of 32 over steps of 32 columns of cat,
    LayerNorm over E*M."""
    m, n = len(xs), xs[0].shape[0]
    hd = e // heads
    s = -(-hd // ops.HEAD_SLICE)
    em = e * m
    y = torch.empty(n, em)
    for r0 in range(0, n, 64):
        rows = slice(r0, min(n, r0 + 64))
        cat = torch.zeros(rows.stop - r0, -(-em // 32) * 32)
        for h in range(heads):
            logits = 0.0
            for p in range(1 if s == 1 else 2):
                for ds in range(s):
                    acc = []
                    for x, (hi, lo), b in zip(xs, packed['wqkv'],
                                              packed['bqkv']):
                        c = -(-x.shape[1] // 32) * 32
                        w = _unpack(hi + lo, c, 48)[h * s + ds]
                        xp = F.pad(x[rows], (0, c - x.shape[1]))
                        acc.append(sum(xp[:, k:k + 32] @ w[k:k + 32]
                                       for k in range(0, c, 32))
                                   + b[h * s + ds])
                    q, k, v = (torch.stack([a[:, 16 * i:16 * i + 16]
                                            for a in acc], 1)
                               for i in range(3))
                    part = q @ k.transpose(1, 2)  # (rows, m1, m2)
                    if s > 1 and p == 0:
                        logits = logits + part
                        continue
                    attn = torch.softmax((logits if s > 1 else part)
                                         / math.sqrt(hd), dim=-1)
                    vals = attn @ v + v  # (rows, m1, 16)
                    for t in range(ops.HEAD_SLICE):
                        d = ops.HEAD_SLICE * ds + t
                        if d < hd:
                            cols = [(h * m + m1) * hd + d
                                    for m1 in range(m)]
                            cat[:, cols] = vals[:, :, t]
        hi, lo = packed['wo']
        o = torch.cat([sum(cat[:, k:k + 32] @ w[k:k + 32]
                           for k in range(0, cat.shape[1], 32))
                       for w in (_unpack(p, cat.shape[1], ops.O_CHUNK)
                                 for p in hi + lo)], dim=1)[:, :em] + bo
        y[rows] = F.layer_norm(o, (em,), ln_scale, ln_bias, ops.LN_EPS)
    return y


@pytest.mark.parametrize('mods,e,heads', CASES, ids=IDS)
def test_kernel_steps_over_the_packed_weights(mods, e, heads):
    """The packing and the kernel's order of work agree with the plain
    version: :func:`_kernel_steps` on 150 frames (three tiles, the last
    ragged) within the float32 gate."""
    params, x = _case(mods, e, seed=11, b=1, t=150)
    xs, wqkv, bqkv, wo, bo, ln_s, ln_b = _torch_args(params, x, mods)
    packed = ops.pack_fusion_weights(wqkv, bqkv, wo, modal_dim=e,
                                     num_heads=heads)
    got = _kernel_steps([v[0] for v in xs], packed, bo, ln_s, ln_b, e,
                        heads)
    want = ops.fused_multimodal_fusion_ref(
        xs, wqkv, bqkv, wo, bo, ln_s, ln_b, modal_dim=e, num_heads=heads)
    np.testing.assert_allclose(got.numpy(), want[0].numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('widths,e,heads,ok', [
    ((128, 32, 128), 32, 2, True),
    ((128,) * 7, 36, 3, True),     # E*M = 252
    ((4,), 32, 32, True),          # hd = 1
    ((64, 64, 64, 64, 64), 64, 2, True),   # E*M = 320: o via y
    ((128,) * 7, 80, 2, True),     # E*M = 560
    ((128,) * 5, 128, 2, True),    # E*M = 640: cat through the workspace
    ((32,) * 7, 256, 4, True),     # E*M = 1792
    ((128, 30), 32, 2, False),     # a width not a multiple of 4
    ((128,), 30, 2, False),        # E not a multiple of 4
    ((128,), 32, 3, False),        # E not a multiple of H
    ((), 32, 2, False), ((32,) * 8, 32, 2, False)])
def test_shapes_the_kernel_takes(widths, e, heads, ok):
    if ok:
        ops.check_tf32x3_shape(widths, e, heads)
    else:
        with pytest.raises(ValueError):
            ops.check_tf32x3_shape(widths, e, heads)


def test_cpu_path_of_both_wrappers():
    """On CPU tensors both kernels' wrappers run the plain version, with
    or without the packed weights."""
    params, x = _case(MAIN, 32, seed=5)
    args = _torch_args(params, x, MAIN)
    kw = dict(modal_dim=32, num_heads=2)
    want = ops.fused_multimodal_fusion_ref(*args, **kw)
    packed = ops.pack_fusion_weights(*args[1:4], **kw)
    for got in (ops.fused_multimodal_fusion(*args, **kw),
                ops.fused_multimodal_fusion(*args, **kw, packed=packed),
                ops.fused_multimodal_fusion_simt(*args, **kw)):
        assert torch.equal(got, want)


def test_wrappers_refuse_a_device_without_kernel():
    x = torch.zeros(1, 2, 4, device='meta')
    w = torch.zeros(4, 96, device='meta')
    b = torch.zeros(96, device='meta')
    wo = torch.zeros(32, 32, device='meta')
    v = torch.zeros(32, device='meta')
    for fn in (ops.fused_multimodal_fusion, ops.fused_multimodal_fusion_simt):
        with pytest.raises(ValueError, match='no kernel'):
            fn([x], [w], [b], wo, v, v, v, modal_dim=32, num_heads=2)


def _packed_of(module):
    """``pack_fusion_weights`` of the module's parameters."""
    attn = module.layers.self_attn
    lins = [attn.qkv_proj[m] for m in module.modalities]
    return ops.pack_fusion_weights(
        [lin.weight.detach().t() for lin in lins],
        [lin.bias.detach() for lin in lins],
        attn.o_proj.weight.detach().t(), modal_dim=module.modal_dim,
        num_heads=module.num_heads)


def _same_packed(got, want):
    parts = [(g, w) for gp, wp in zip(got['wqkv'], want['wqkv'])
             for g, w in zip(gp, wp)]
    parts += list(zip(got['bqkv'], want['bqkv']))
    parts += list(zip(got['wo'], want['wo']))
    return all(torch.equal(g, w) for g, w in parts)


def test_eval_weights_are_kept_and_derived_again():
    """``eval_weights`` derives the packed weights once and keeps them,
    detached; ``load_state_dict`` or an in-place write of a parameter
    makes it derive them again."""
    dims = {m: MC.ENCODER_DIM[m] for m in MAIN}
    module = MultimodalTransformerEncoder(MAIN, dims, 32, 2)
    module.reset_parameters(torch.Generator().manual_seed(0))
    first = module.eval_weights()
    assert module.eval_weights() is first
    assert _same_packed(first, _packed_of(module))
    assert not any(t.requires_grad for t in (
        *first['wo'], *first['bqkv'], *first['wqkv'][0]))
    attn = module.layers.self_attn
    with torch.no_grad():
        attn.o_proj.weight.mul_(2.0)
    again = module.eval_weights()
    assert again is not first
    assert torch.equal(again['wo'][0], 2.0 * first['wo'][0])
    assert _same_packed(again, _packed_of(module))
    params, _ = _case(MAIN, 32, seed=9)
    module.load_state_dict(fusion_state_from_flax(params, MAIN), strict=True)
    loaded = module.eval_weights()
    assert loaded is not again
    assert _same_packed(loaded, _packed_of(module))
    wo = torch.from_numpy(params['self_attn']['o_proj']['dense']['kernel'])
    assert torch.equal(loaded['wo'][0], ops.pack_fusion_weights(
        [], [], wo, modal_dim=32, num_heads=2)['wo'][0])


def test_cpu_forward_packs_nothing():
    """On the CPU the eval forward runs the plain version on the
    parameters (views, no copy) and packs nothing; the kept weights are
    derived only for the card (or when asked for)."""
    params, x = _case(MAIN, 32, seed=17)
    dims = {m: MC.ENCODER_DIM[m] for m in MAIN}
    module = MultimodalTransformerEncoder(MAIN, dims, 32, 2)
    module.load_state_dict(fusion_state_from_flax(params, MAIN), strict=True)
    with torch.inference_mode():
        got = module({m: torch.from_numpy(v) for m, v in x.items()})
        want = module({m: torch.from_numpy(v) for m, v in x.items()},
                      reference=True)
    assert module._eval is None
    assert torch.equal(got, want)


@pytest.mark.parametrize('mods', [MAIN, CASES[4][0]], ids=['M3', 'M7'])
def test_encoder_through_the_bridge_matches_flax(mods):
    """The port's module, loaded through ``fusion_state_from_flax``, in
    eval mode (the plain version on the CPU) and with the emulation on
    its parameters, against flax's MultimodalTransformerEncoder in eval
    mode."""
    params, x = _case(mods, 32, seed=13, b=2, t=16)
    dims = {m: MC.ENCODER_DIM[m] for m in mods}
    want = FlaxMTE(mods, dims, 32, 2, dropout=0.1).apply(
        {'params': params}, {m: jnp.asarray(v) for m, v in x.items()},
        train=False)
    module = MultimodalTransformerEncoder(mods, dims, 32, 2)
    module.load_state_dict(fusion_state_from_flax(params, mods), strict=True)
    attn = module.layers.self_attn
    lins = [attn.qkv_proj[m] for m in mods]
    with torch.inference_mode():
        got = module({m: torch.from_numpy(v) for m, v in x.items()})
        emulated = ops.fused_multimodal_fusion_tf32x3_ref(
            [torch.from_numpy(x[m]) for m in mods],
            [lin.weight.t() for lin in lins], [lin.bias for lin in lins],
            attn.o_proj.weight.t(), attn.o_proj.bias,
            module.layers.norm1.weight, module.layers.norm1.bias,
            modal_dim=32, num_heads=2)
    for out in (got, emulated):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
