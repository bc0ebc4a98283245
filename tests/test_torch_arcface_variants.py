"""The ArcFace backbone's conv paths in the port vs fvt_tpu's, on the same
weights, and a tri-modal LFAN served through a variant backbone.

One module-scoped fixture initialises the flax ``VisualBackbone`` (IR-50
at its fixed depth), moves every BatchNorm and PReLU off its init value
and carries the weights into the port through ``from_jax``.  The JAX side
runs ``VisualBackbone(conv_impl='winograd_pallas')`` and
``arcface_forward_eval(fused_blocks=True)`` with the Pallas kernels in
interpret mode, once, in the fixture; the port runs on the CPU, where the
kernel wrappers take their plain versions.  Outputs are l2-normalised
512-d embeddings after 50 fp32 conv layers summed in another order (and,
for Winograd, through the transforms): rtol 2e-4, atol 2e-5, as
``test_arcface_matches_flax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.models.arcface import (VisualBackbone as FlaxVisualBackbone,
                                    arcface_forward_eval as flax_forward_eval)
from fvt_tpu_torch.models.arcface import (CONV_IMPLS, Conv3x3, VisualBackbone,
                                          arcface_forward_eval)
from fvt_tpu_torch.models.from_jax import visual_backbone_state_from_flax
from fvt_tpu_torch.models.models import LFAN
from fvt_tpu_torch.ops.bottleneck import bottleneck_ir_fused
from fvt_tpu_torch.ops.conv import conv3x3
from fvt_tpu_torch.ops.winograd import conv3x3_winograd
from fvt_tpu_torch.serve import lfan_serving_forward

N = 2
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, and torch's spinning threads made this file's runs tens of
    times slower there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng, stats: bool):
    def move(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf, np.float32)
        if stats and name == 'mean':
            return leaf + rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        if name in ('var', 'scale'):
            return leaf * rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == 'bias':
            return leaf + rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        if name == 'alpha':
            return rng.uniform(0.1, 0.4, leaf.shape).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(move, tree)


@pytest.fixture(scope='module')
def arcface():
    rng = np.random.default_rng(0)
    variables = jax.jit(lambda r, x: FlaxVisualBackbone().init(
        r, x, train=False))(jax.random.key(1), jnp.zeros((1, 40, 40, 3)))
    params = _perturb(variables['params'], rng, stats=False)
    stats = _perturb(variables['batch_stats'], rng, stats=True)
    state = visual_backbone_state_from_flax(params, stats)
    crops = rng.uniform(-1, 1, (N, 40, 40, 3)).astype(np.float32)
    direct = np.asarray(jax.jit(lambda v, x: FlaxVisualBackbone().apply(
        v, x, train=False))({'params': params, 'batch_stats': stats},
                            jnp.asarray(crops)))
    variables = {'params': params, 'batch_stats': stats}
    pallas = np.asarray(jax.jit(
        lambda v, x: FlaxVisualBackbone(conv_impl='winograd_pallas').apply(
            v, x, train=False))(variables, jnp.asarray(crops)))
    fused = np.asarray(flax_forward_eval(
        params, stats, jnp.asarray(crops), dtype=jnp.float32,
        fused_blocks=True, interpret=True))
    return {'state': state, 'crops': crops, 'direct': direct,
            'winograd_pallas': pallas, 'fused_blocks': fused}


def _port(arcface, **kw):
    model = VisualBackbone(**kw).eval()
    model.load_state_dict(arcface['state'], strict=True)
    return model


# 'int8' quantises, so it is held against fvt_tpu's int8 backbone
# (tests/test_torch_arcface_int8.py), not against the float paths
@pytest.mark.parametrize('conv_impl', [i for i in CONV_IMPLS if i != 'int8'])
def test_backbone_conv_impl_matches_flax_winograd_pallas(arcface, conv_impl):
    """Each float conv path of the port against fvt_tpu's fused Winograd
    path (Pallas, interpret mode) and its direct path."""
    want = arcface['winograd_pallas']
    model = _port(arcface, conv_impl=conv_impl)
    with torch.inference_mode():
        got = model(torch.from_numpy(arcface['crops'])).numpy()
    assert got.shape == (N, 512)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, arcface['direct'], rtol=RTOL, atol=ATOL)
    # only the stride-1 3x3 convs of the body take the path: 24 conv1 and
    # the 21 conv2 of the stride-1 blocks
    convs = [m for m in model.modules() if isinstance(m, Conv3x3)]
    assert len(convs) == 48 and all(c.impl == conv_impl for c in convs)
    assert sum(c.stride == 1 for c in convs) == 45


@pytest.mark.parametrize('reference', [False, True])
def test_fused_blocks_match_flax_forward_eval(arcface, reference):
    """``fused_blocks=True`` against fvt_tpu's functional eval forward
    through the fused Pallas block in interpret mode."""
    want = arcface['fused_blocks']
    x = torch.from_numpy(arcface['crops'])
    model = _port(arcface)
    got = arcface_forward_eval(model, x, fused_blocks=True,
                               reference=reference).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, arcface['direct'], rtol=RTOL, atol=ATOL)
    with torch.inference_mode():
        by_module = _port(arcface, fused_blocks=True)(x).numpy()
    np.testing.assert_array_equal(by_module, got)
    assert sum(blk.fusable for blk in model.backbone.body) == 21


def test_derived_weights_follow_the_parameters(arcface):
    """The kernels' weights are cached per module and derived again when
    a parameter or a running statistic is written."""
    model = _port(arcface, conv_impl='winograd', fused_blocks=True)
    x = torch.from_numpy(arcface['crops'])
    with torch.inference_mode():
        first = model(x)
    blk = model.backbone.body[1]
    kept = blk.fused_weights()
    assert blk.fused_weights() is kept
    with torch.no_grad():
        blk.res_layer[0].running_mean.add_(0.5)
        model.backbone.body[3].res_layer[1].weight.mul_(1.5)
    assert blk.fused_weights() is not kept
    fresh = _port(arcface, conv_impl='winograd', fused_blocks=True)
    fresh.load_state_dict(model.state_dict())
    with torch.inference_mode():
        second, want = model(x), fresh(x)
    assert (second - first).abs().max() > 1e-4
    np.testing.assert_array_equal(second.numpy(), want.numpy())


def test_conv_paths_are_eval_only_and_checked():
    # 'int8' is a path since int8 serving was ported; 'int4' is none
    with pytest.raises(ValueError, match='unknown conv impl'):
        VisualBackbone(conv_impl='int4')
    for impl, c in (('shifted_kernel', 4), ('int8', 128)):
        conv = Conv3x3(c, 4, impl=impl)
        torch.nn.init.normal_(conv.weight)
        with pytest.raises(RuntimeError, match='no backward'):
            conv(torch.zeros(1, c, 2, 2))
        with torch.no_grad():
            assert conv(torch.zeros(1, c, 2, 2)).shape == (1, 4, 2, 2)


@pytest.mark.parametrize('kw', [{'conv_impl': 'winograd_kernel'},
                                {'conv_impl': 'shifted_kernel'},
                                {'fused_blocks': True}])
def test_lfan_serving_with_a_variant_backbone(kw):
    """The tri-modal serving forward with a variant backbone against the
    default one on the same weights; logits, atol 1e-4 as the slice test
    (fp32 through 50 conv layers summed in another order).  On the CPU no
    kernel is launched."""
    mods = ('video', 'vggish', 'bert')
    tcn = {'video': [32, 32, 16, 16], 'vggish': [16, 16, 8, 8],
           'bert': [32, 32, 16, 16]}
    enc = {m: c[-1] for m, c in tcn.items()}
    default = LFAN(mods, 7, tcn_channel=tcn, encoder_dim=enc,
                   generator=torch.Generator().manual_seed(3))
    variant = LFAN(mods, 7, tcn_channel=tcn, encoder_dim=enc, **kw)
    variant.load_state_dict(default.state_dict(), strict=True)
    rng = np.random.default_rng(7)
    batch = {
        'video': torch.from_numpy(rng.integers(0, 256, (1, 4, 40, 40, 3),
                                               dtype=np.uint8)),
        'vggish': torch.from_numpy(rng.normal(size=(1, 4, 128))
                                   .astype(np.float32)),
        'bert': torch.from_numpy(rng.normal(size=(1, 4, 768))
                                 .astype(np.float32))}
    want = lfan_serving_forward(default, batch)
    got = lfan_serving_forward(variant, batch)
    plain = lfan_serving_forward(variant, batch, reference=True)
    assert got.shape == (1, 4, 7)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(plain.numpy(), want.numpy(), rtol=0,
                               atol=1e-4)
    assert (conv3x3.launches, conv3x3_winograd.launches,
            bottleneck_ir_fused.launches) == (0, 0, 0)
    ready = LFAN(mods, 7, tcn_channel=tcn, encoder_dim=enc,
                 spatial_video=VisualBackbone(**kw))
    assert ready.spatial.visual.fused_blocks == kw.get('fused_blocks', False)
