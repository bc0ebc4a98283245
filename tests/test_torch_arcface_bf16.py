"""The ArcFace backbone in bfloat16 (fvt_tpu's ``--amp``) in the port vs
fvt_tpu's, on the same weights, and a tri-modal LFAN served with it.

One module-scoped fixture initialises the flax ``VisualBackbone`` (IR-50
at its fixed depth), moves every BatchNorm and PReLU off its init value
and carries the float32 parameters into the port through ``from_jax``
(bfloat16 is a compute type: the bridge carries nothing new for it).  The
JAX side runs ``VisualBackbone(dtype=jnp.bfloat16)`` and
``arcface_forward_eval(dtype=jnp.bfloat16)`` once, in the fixture; the
port runs on the CPU, where ``'shifted_kernel'`` takes the conv's plain
version.  The two frameworks round at other places (flax normalises in
bfloat16, ``F.batch_norm`` in float32 with one rounding), so the yardstick
is bfloat16's own distance from float32 on the JAX side: the port's
bfloat16 embeddings lie within twice that of each JAX bfloat16 result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.models.arcface import (VisualBackbone as FlaxVisualBackbone,
                                    arcface_forward_eval as flax_forward_eval)
from fvt_tpu_torch.models.arcface import (Backbone, BottleneckIR, Conv3x3,
                                          VisualBackbone,
                                          arcface_forward_eval)
from fvt_tpu_torch.models.from_jax import visual_backbone_state_from_flax
from fvt_tpu_torch.models.models import LFAN
from fvt_tpu_torch.ops.conv import conv3x3, pack_weights
from fvt_tpu_torch.ops.winograd import check_widths
from fvt_tpu_torch.serve import ServingModel, lfan_serving_forward
from fvt_tpu_torch.streaming import StreamingSession
from test_torch_arcface_variants import _perturb

N = 2
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, and torch's spinning threads made this file's runs tens of
    times slower there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def arcface():
    rng = np.random.default_rng(0)
    variables = jax.jit(lambda r, x: FlaxVisualBackbone().init(
        r, x, train=False))(jax.random.key(1), jnp.zeros((1, 40, 40, 3)))
    params = _perturb(variables['params'], rng, stats=False)
    stats = _perturb(variables['batch_stats'], rng, stats=True)
    variables = {'params': params, 'batch_stats': stats}
    crops = rng.uniform(-1, 1, (N, 40, 40, 3)).astype(np.float32)

    def flax(dtype):
        return np.asarray(jax.jit(
            lambda v, x: FlaxVisualBackbone(dtype=dtype).apply(
                v, x, train=False))(variables, jnp.asarray(crops)))

    fp32, module = flax(jnp.float32), flax(jnp.bfloat16)
    functional = np.asarray(flax_forward_eval(
        params, stats, jnp.asarray(crops), dtype=jnp.bfloat16))
    assert module.dtype == functional.dtype == np.float32
    return {'state': visual_backbone_state_from_flax(params, stats),
            'crops': crops, 'fp32': fp32, 'module': module,
            'functional': functional, 'params': params, 'stats': stats}


@pytest.fixture(scope='module')
def fused_bf16(arcface):
    """``arcface_forward_eval(dtype=bfloat16, fused_blocks=True)``: the 21
    identity blocks through the Pallas block in interpret mode."""
    return np.asarray(flax_forward_eval(
        arcface['params'], arcface['stats'], jnp.asarray(arcface['crops']),
        dtype=jnp.bfloat16, fused_blocks=True))


def _port(arcface, **kw):
    model = VisualBackbone(**kw).eval()
    model.load_state_dict(arcface['state'], strict=True)
    return model


@pytest.mark.parametrize('flax_path', ['module', 'functional'])
@pytest.mark.parametrize('conv_impl', ['cudnn', 'shifted_kernel'])
def test_bf16_backbone_matches_flax_bf16(arcface, conv_impl, flax_path):
    want = arcface[flax_path]
    own = np.abs(want - arcface['fp32']).max()  # JAX bf16 vs JAX fp32
    model = _port(arcface, conv_impl=conv_impl, dtype=BF16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in model.buffers())
    x = torch.from_numpy(arcface['crops'])
    got = arcface_forward_eval(model, x, dtype=BF16)
    assert got.dtype == torch.float32 and got.shape == (N, 512)
    got = got.numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    apart = np.abs(got - want).max()
    assert 0 < own and apart <= 2 * own, (
        f'port bf16 vs JAX bf16 ({flax_path}): {apart}; JAX bf16 vs JAX '
        f'fp32: {own}')
    # it did compute in bfloat16: not the float32 result
    assert np.abs(got - arcface['fp32']).max() > 1e-4
    with torch.inference_mode():
        np.testing.assert_array_equal(model(x).numpy(), got)
        plain = model(x, reference=True).numpy()
    np.testing.assert_array_equal(plain, got)  # the CPU takes the plain one
    assert conv3x3.launches == 0 and conv3x3.launches_bf16 == 0


@pytest.mark.parametrize('kw', [{'conv_impl': 'winograd'},
                                {'conv_impl': 'winograd_kernel'}])
def test_bf16_has_no_winograd_or_fused_route_yet(kw):
    """The bfloat16 Winograd routes are taken (the test keeps the name it
    had while bfloat16 raised for them): alone, with the fused blocks
    beside them and inside an LFAN, each 3x3 conv of the body on the
    chosen path in bfloat16; float32 takes every path too."""
    model = VisualBackbone(dtype=BF16, **kw)
    convs = [m for m in model.modules() if isinstance(m, Conv3x3)]
    assert len(convs) == 48 and model.dtype == BF16
    assert all(c.impl == kw['conv_impl'] and c.dtype == BF16 for c in convs)
    lfan = LFAN(('video', 'vggish'), 7, backbone_dtype=BF16, **kw)
    assert lfan.spatial.visual.dtype == BF16
    VisualBackbone(**kw)  # float32 takes every path
    fused = VisualBackbone(dtype=BF16, fused_blocks=True, **kw)
    assert fused.fused_blocks and fused.dtype == BF16
    lfan = LFAN(('video', 'vggish'), 7, backbone_dtype=BF16,
                fused_blocks=True, **kw)
    assert lfan.spatial.visual.fused_blocks


@pytest.mark.parametrize('conv_impl', ['cudnn', 'shifted_kernel'])
def test_bf16_fused_blocks_are_taken(conv_impl):
    """``fused_blocks=True`` in bfloat16 (the fused block's bfloat16
    route) is built on either conv path that bfloat16 takes, alone and
    inside an LFAN."""
    model = VisualBackbone(dtype=BF16, fused_blocks=True,
                           conv_impl=conv_impl)
    assert model.fused_blocks and model.dtype == BF16
    lfan = LFAN(('video', 'vggish'), 7, backbone_dtype=BF16,
                fused_blocks=True, conv_impl=conv_impl)
    assert lfan.spatial.visual.fused_blocks


@pytest.mark.parametrize('conv_impl', ['cudnn', 'shifted_kernel'])
def test_bf16_fused_backbone_matches_flax_bf16(arcface, fused_bf16,
                                              conv_impl):
    """The port's bfloat16 backbone with ``fused_blocks=True`` (the plain
    version of the bfloat16 block in the 21 identity blocks on the CPU)
    against fvt_tpu's ``arcface_forward_eval(dtype=bfloat16,
    fused_blocks=True)`` (the Pallas block in interpret mode) within twice
    bfloat16's own distance from float32, as the unfused paths."""
    own = np.abs(arcface['functional'] - arcface['fp32']).max()
    model = _port(arcface, conv_impl=conv_impl, dtype=BF16,
                  fused_blocks=True)
    x = torch.from_numpy(arcface['crops'])
    with torch.inference_mode():
        got = model(x)
    assert got.dtype == torch.float32 and got.shape == (N, 512)
    got = got.numpy()
    apart = np.abs(got - fused_bf16).max()
    assert 0 < own and apart <= 2 * own, (
        f'port bf16 fused vs JAX bf16 fused: {apart}; JAX bf16 vs JAX '
        f'fp32: {own}')
    assert np.abs(got - arcface['fp32']).max() > 1e-4
    with torch.inference_mode():
        np.testing.assert_array_equal(
            arcface_forward_eval(model, x, fused_blocks=True).numpy(), got)


def test_bf16_checks_at_every_level():
    """Every level takes bfloat16 on every path and refuses another type;
    the bfloat16 Winograd kernel refuses widths it does not take (the
    shape check of a CUDA tensor, ``ops.winograd.check_widths``)."""
    Conv3x3(16, 16, impl='winograd', dtype=BF16)
    BottleneckIR(16, 16, 1, 'winograd_kernel', BF16)
    Backbone(conv_impl='winograd', dtype=BF16)
    for level in (lambda: Conv3x3(16, 16, impl='winograd_kernel',
                                  dtype=torch.float16),
                  lambda: BottleneckIR(16, 16, 1, 'winograd', torch.float16),
                  lambda: Backbone(dtype=torch.float64)):
        with pytest.raises(ValueError, match='float32 or torch.bfloat16'):
            level()
    with pytest.raises(ValueError, match='multiples of 16'):
        check_widths('conv3x3_winograd', BF16, 20, 40)
    with pytest.raises(ValueError, match='float32 or torch.bfloat16'):
        VisualBackbone(dtype=torch.float16)
    # the fused block takes bfloat16 since it has a bfloat16 route
    blk = BottleneckIR(16, 16, 1, 'shifted_kernel', BF16).eval()
    with torch.no_grad():
        y = blk(torch.zeros(1, 16, 4, 4, dtype=BF16), fused=True)
    assert y.dtype == BF16 and y.shape == (1, 16, 4, 4)
    model = VisualBackbone(dtype=BF16)
    with pytest.raises(ValueError, match='built with'):
        arcface_forward_eval(model, torch.zeros(1, 40, 40, 3),
                             dtype=torch.float32)
    out = arcface_forward_eval(model, torch.zeros(1, 40, 40, 3),
                               fused_blocks=True)
    assert out.shape == (1, 512) and out.dtype == torch.float32


def test_bf16_derived_weights_follow_the_parameters(arcface):
    """The bfloat16 copies the convolutions compute with are cached per
    module and made again when the float32 parameter is written in place
    or replaced."""
    model = _port(arcface, conv_impl='shifted_kernel', dtype=BF16)
    x = torch.from_numpy(arcface['crops'])
    with torch.inference_mode():
        first = model(x)
    conv = model.backbone.body[3].res_layer[1]
    kept = conv.cast_weights()
    assert conv.cast_weights()[1] is kept[1]
    assert kept[0].dtype == kept[1].dtype == BF16
    assert kept[0].shape == conv.weight.shape              # OIHW
    assert kept[1].shape == (3, 3) + conv.weight.shape[1::-1]  # HWIO
    assert kept[1].is_contiguous() and conv.weight.dtype == torch.float32
    assert torch.equal(kept[2], pack_weights(kept[1]))     # for the kernel
    shortcut = model.backbone.body[3].shortcut_layer[0]
    prelu = model.backbone.input_layer[2]
    with torch.no_grad():
        conv.weight.mul_(1.5)                      # written in place
        shortcut.weight = torch.nn.Parameter(shortcut.weight * 0.5)
        prelu.weight.add_(0.3)
    assert conv.cast_weights()[1] is not kept[1]
    torch.testing.assert_close(conv.cast_weights()[0],
                               conv.weight.detach().to(BF16), rtol=0, atol=0)
    fresh = _port(arcface, conv_impl='shifted_kernel', dtype=BF16)
    fresh.load_state_dict(model.state_dict())
    with torch.inference_mode():
        second, want = model(x), fresh(x)
    assert (second - first).abs().max() > 1e-3
    np.testing.assert_array_equal(second.numpy(), want.numpy())


@pytest.mark.parametrize('conv_impl', ['cudnn', 'shifted_kernel',
                                       'winograd_kernel'])
def test_lfan_serving_with_a_bf16_backbone(conv_impl):
    """The tri-modal LFAN with ``backbone_dtype=bfloat16`` through
    ``ServingModel`` and the streaming session, against the float32 model
    on the same weights.  Logits are O(1); bfloat16 keeps 8 bits and moves
    the embeddings' components (~0.04) by a few 1e-3, which the TCN and
    the regressor carry to the logits: atol 2e-2."""
    mods = ('video', 'vggish', 'bert')
    tcn = {'video': [32, 32, 16, 16], 'vggish': [16, 16, 8, 8],
           'bert': [32, 32, 16, 16]}
    enc = {m: c[-1] for m, c in tcn.items()}
    default = LFAN(mods, 7, tcn_channel=tcn, encoder_dim=enc,
                   generator=torch.Generator().manual_seed(3))
    variant = LFAN(mods, 7, tcn_channel=tcn, encoder_dim=enc,
                   conv_impl=conv_impl, backbone_dtype=BF16)
    variant.load_state_dict(default.state_dict(), strict=True)
    assert variant.spatial.visual.dtype == BF16
    assert all(p.dtype == torch.float32 for p in variant.parameters())
    rng = np.random.default_rng(7)
    frames = {'video': rng.integers(0, 256, (9, 40, 40, 3), dtype=np.uint8),
              'vggish': rng.normal(size=(9, 128)).astype(np.float32),
              'bert': rng.normal(size=(9, 768)).astype(np.float32)}
    served = {}
    for name, model in (('fp32', default), ('bf16', variant)):
        server = ServingModel(model, 2, 6, 4, 'cpu')
        assert server.specs['video']['dtype'] == 'uint8'
        assert server.specs['bert']['dtype'] == 'float32'
        sess = StreamingSession(server)
        first = sess.feed(frames)[1]
        served[name] = np.concatenate([first, sess.close()[1]])
    got, want = served['bf16'], served['fp32']
    assert got.shape == (9, 7) and got.dtype == np.float32
    assert np.isfinite(got).all()
    apart = np.abs(got - want).max()
    assert 0 < apart <= 2e-2, apart
    batch = {k: torch.from_numpy(v[None, :6]) for k, v in frames.items()}
    logits = lfan_serving_forward(variant, batch)
    plain = lfan_serving_forward(variant, batch, reference=True)
    assert logits.dtype == torch.float32 and logits.shape == (1, 6, 7)
    np.testing.assert_array_equal(logits.numpy(), plain.numpy())
    assert conv3x3.launches == 0
