"""The port's tri-modal LFAN serving slice vs fvt_tpu's, on the same weights.

One module-scoped fixture builds the flax tri-modal LFAN
(``video+vggish+bert``: ArcFace IR-50 at its fixed depth, narrow TCNs,
``encoder_dim`` to match), moves every BatchNorm, weight-norm g, PReLU
and bias off its init value (at init g == ||v|| and BN is the identity,
which would hide a dropped g or a wrong BN fold), and carries the weights
into the port through ``from_jax``.  Every test that needs the ArcFace
tree lives here, so the expensive init runs once.

The JAX side runs ``fvt_tpu.serve.build_lfan_serving_fn`` with the Pallas
kernels in interpret mode; the port runs on the CPU, where its kernel
wrappers take their plain versions.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvt_tpu.models.arcface import VisualBackbone as FlaxVisualBackbone
from fvt_tpu.models.models import LFAN as FlaxLFAN
from fvt_tpu.serve import build_lfan_serving_fn
from fvt_tpu_torch.models.from_jax import is_dead_key, state_from_flax
from fvt_tpu_torch.models.models import LFAN
from fvt_tpu_torch.serve import lfan_serving_forward

MODS = ('video', 'vggish', 'bert')
TCN = {'video': [32, 32, 16, 16], 'vggish': [16, 16, 8, 8],
       'bert': [32, 32, 16, 16]}
ENC = {m: c[-1] for m, c in TCN.items()}
B, T = 2, 12


def _perturb(tree, rng, stats: bool):
    def move(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf, np.float32)
        if stats and name == 'mean':
            return leaf + rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        if stats and name == 'var':
            return leaf * rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ('g', 'scale'):
            return leaf * rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == 'bias':
            return leaf + rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        if name == 'alpha':
            return rng.uniform(0.1, 0.4, leaf.shape).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(move, tree)


@pytest.fixture(scope='module')
def tri_modal():
    rng = np.random.default_rng(0)
    # the LFAN on video features and the ArcFace are initialised apart:
    # the same trees as one init through the backbone, at a fraction of
    # its time
    feat_model = FlaxLFAN(modality=MODS, output_dim=7, tcn_channel=TCN,
                          encoder_dim=ENC)
    feats = {'video': jnp.zeros((1, 8, 512)), 'vggish': jnp.zeros((1, 8, 128)),
             'bert': jnp.zeros((1, 8, 768))}
    lfan_vars = jax.jit(lambda r, x: feat_model.init(r, x, train=False))(
        jax.random.key(0), feats)
    arc_vars = jax.jit(lambda r, x: FlaxVisualBackbone().init(
        r, x, train=False))(jax.random.key(1), jnp.zeros((1, 40, 40, 3)))
    params = dict(lfan_vars['params'], spatial_video=arc_vars['params'])
    stats = dict(lfan_vars['batch_stats'],
                 spatial_video=arc_vars['batch_stats'])
    params = _perturb(params, rng, stats=False)
    stats = _perturb(stats, rng, stats=True)

    model = FlaxLFAN(modality=MODS, output_dim=7, tcn_channel=TCN,
                     encoder_dim=ENC, spatial_video=FlaxVisualBackbone())
    port = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC)
    port.load_state_dict(state_from_flax(params, stats, MODS),
                         strict=True)
    batch = {
        'video': rng.integers(0, 256, (B, T, 40, 40, 3), dtype=np.uint8),
        'vggish': rng.normal(size=(B, T, 128)).astype(np.float32),
        'bert': rng.normal(size=(B, T, 768)).astype(np.float32),
    }
    return {'model': model, 'params': params, 'stats': stats,
            'port': port, 'batch': batch}


def test_slice_logits_match_fvt_tpu(tri_modal):
    """Full serving forward, uint8 video in, logits out; atol 1e-4 on
    logits: fp32 through 50 conv layers summed in another order."""
    serve_fn = build_lfan_serving_fn(
        tri_modal['model'], {'params': tri_modal['params'],
                             'batch_stats': tri_modal['stats']},
        interpret=True)
    want = np.asarray(serve_fn({k: jnp.asarray(v)
                                for k, v in tri_modal['batch'].items()}))
    got = lfan_serving_forward(
        tri_modal['port'],
        {k: torch.from_numpy(v) for k, v in tri_modal['batch'].items()})
    assert got.shape == (B, T, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_arcface_matches_flax(tri_modal):
    """The backbone alone on normalised crops: unit-norm 512-d
    embeddings, fp32, rtol 2e-4 / atol 2e-5."""
    rng = np.random.default_rng(5)
    crops = rng.uniform(-1, 1, (6, 40, 40, 3)).astype(np.float32)
    want = FlaxVisualBackbone().apply(
        {'params': tri_modal['params']['spatial_video'],
         'batch_stats': tri_modal['stats']['spatial_video']},
        jnp.asarray(crops), train=False)
    with torch.inference_mode():
        got = tri_modal['port'].spatial.visual(torch.from_numpy(crops))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_bridge_spatial_keys_match_torch_export(tri_modal):
    """The bridge's ArcFace keys and values equal torch_export's, which
    fvt_tpu pins against the upstream PyTorch model; only the dead
    ``spatial.visual.logits`` is left out."""
    from fvt_tpu.config import model_config as MC
    from fvt_tpu.models.torch_export import lfan_to_torch

    want = {k: v for k, v in lfan_to_torch(
        tri_modal['params'], tri_modal['stats'], MODS, TCN,
        MC.EMBEDDING_DIM).items() if k.startswith('spatial.')}
    got = {k: v for k, v in state_from_flax(
        tri_modal['params'], tri_modal['stats'], MODS).items()
        if k.startswith('spatial.')}
    assert set(want) - set(got) == {'spatial.visual.logits.weight',
                                    'spatial.visual.logits.bias'}
    assert all(is_dead_key(k) for k in set(want) - set(got))
    assert set(got) <= set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.mark.parametrize('size', [40, 48, 64])
def test_eval_video_transform_matches_fvt_tpu(size):
    """40^2 is only scaled, 48^2 center-cropped, larger resized first."""
    from fvt_tpu.data.transforms import eval_video_transform as jax_tf
    from fvt_tpu_torch.data.transforms import eval_video_transform

    video = np.random.default_rng(size).integers(
        0, 256, (2, 3, size, size, 3), dtype=np.uint8)
    want = jax_tf(jnp.asarray(video).astype(jnp.float32))
    got = eval_video_transform(torch.from_numpy(video))
    assert got.shape == (2, 3, 40, 40, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
