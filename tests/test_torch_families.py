"""The port's CAN, JMT and MT against fvt_tpu's, eval and weights, on the CPU.

The same numpy-seeded inputs go through ``fvt_tpu`` and the port on weights
carried by ``from_jax.state_from_flax`` (fvt_tpu's flax trees filled with
numpy by leaf name, ``test_torch_config_store.flax_variables``):

* the blocks alone: fvt_tpu's ``TorchMultiheadAttention`` with and without
  a key mask, its post-norm ``TransformerEncoderLayer``, CAN's
  ``AttentionFusion``, ``JMTFusion`` and ``MTFusion`` at B = 2 with a
  padded row (the final attention mixes the rows over the flattened
  (B*T) axis; the port reproduces it);
* the three families' eval logits on narrow TCNs with ``video`` as 512-d
  features, with and without ``time_mask``, and the valid prefix of a
  padded JMT/MT row unchanged by its padding; one case per family on raw
  40^2 frames through the IR-50 (two frames; fvt_tpu's
  ``_maybe_encode_spatial`` is its backbone on the frames, so its logits
  there are its logits on that backbone's embeddings, computed once);
* the eval backbone in chunks of frames equal to one pass;
* upstream-named state_dicts (``fvt_tpu.models.torch_export``'s
  ``can_to_torch`` and ``jmt_to_torch``, the ArcFace included) load with
  ``strict=True`` once each family's dead keys are dropped (CAN's
  ``conv_c``, MT's ``fuse.reduce_feats_dim``; JMT's is live) and give
  fvt_tpu's logits;
* ``save_best_model`` writes the bytes of ``flax.serialization.to_bytes``
  for each family, and its reader gives the state back exactly.

Tolerance 1e-5 (absolute, fp32, sums in another order); 1e-4 where the
IR-50's 50 layers are in the path.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvt_tpu.models import fusion as jax_fusion
from fvt_tpu.models import layers as jax_layers
from fvt_tpu.models import models as jax_models
from fvt_tpu.models.arcface import VisualBackbone as FlaxVisualBackbone
from fvt_tpu_torch.models import fusion, layers, models
from fvt_tpu_torch.models.from_jax import is_dead_key, state_from_flax
from test_torch_config_store import flax_variables

ATOL = 1e-5
MODS = ('video', 'vggish', 'bert')
SETTINGS = {'video': {'input_dim': 512, 'channel': [16, 128],
                      'kernel_size': 5},
            'vggish': {'input_dim': 128, 'channel': [16, 8],
                       'kernel_size': 5},
            'bert': {'input_dim': 768, 'channel': [8, 8], 'kernel_size': 3}}
FAMILIES = ('CAN', 'JMT', 'MT')
B, T = 2, 12
LENGTHS = (T, 7)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The suite runs six workers on the machine's cores; torch's intra-op
    threads, each spinning across them, made small CPU runs tens of times
    slower there.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0, b=B, t=T):
    rng = np.random.default_rng(seed)
    return {'video': rng.normal(size=(b, t, 512)).astype(np.float32),
            'vggish': rng.normal(size=(b, t, 128)).astype(np.float32),
            'bert': rng.normal(size=(b, t, 768)).astype(np.float32)}


def _mask(lengths=LENGTHS, t=T):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _torch(x):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()}


def _jax_family(name, settings=SETTINGS, modality=MODS, **kw):
    if name == 'CAN':
        return jax_models.CAN(modality=modality, output_dim=7,
                              tcn_settings=settings, **kw)
    return jax_models.JMT(modality=modality, output_dim=7, model_name=name,
                          tcn_settings=settings, **kw)


def _port_family(name, settings=SETTINGS, modality=MODS):
    if name == 'CAN':
        return models.CAN(modality, 7, tcn_settings=settings)
    return models.JMT(modality, 7, model_name=name, tcn_settings=settings)


def _block_params(module, seed, *args):
    """A flax block's params in its tree layout, filled with numpy as
    ``flax_variables`` fills a model's (the block takes no ``train``)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'scale':
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith('kernel'):
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            a = rng.normal(0, 0.05, shape)
        return a.astype(np.float32)

    shapes = jax.eval_shape(lambda k: module.init(k, *args),
                            jax.random.key(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)['params']


def _sub(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


# -------------------------------------------------------------- the blocks
@pytest.mark.parametrize('masked', [False, True])
def test_multihead_attention_is_fvt_tpus(masked):
    rng = np.random.default_rng(1)
    q, kv = (rng.normal(size=(B, T, 16)).astype(np.float32)
             for _ in range(2))
    mask = _mask() if masked else None
    attn = jax_layers.TorchMultiheadAttention(16, 2)
    params = _block_params(attn, 3, q, kv, kv)
    want = jax.jit(lambda p, q, kv, m: attn.apply(
        {'params': p}, q, kv, kv, key_valid_mask=m))(params, q, kv, mask)
    port = layers.MultiheadAttention(16, 2)
    port.load_state_dict(_sub(state_from_flax({'fuse': {'CA_va': params}},
                                              {}), 'fuse.CA_va.'),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(q), torch.from_numpy(kv),
                   torch.from_numpy(kv),
                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    if masked:  # the padded keys carry no weight: changing them moves
        # nothing of the rows' output
        kv2 = kv.copy()
        kv2[1, LENGTHS[1]:] = 100.0
        with torch.no_grad():
            moved = port(torch.from_numpy(q), torch.from_numpy(kv2),
                         torch.from_numpy(kv2), torch.from_numpy(mask))
        np.testing.assert_array_equal(moved.numpy(), got.numpy())


def test_encoder_layer_and_gating_are_fvt_tpus():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, T, 128)).astype(np.float32)
    mask = _mask()
    layer = jax_fusion.TransformerEncoderLayer(128, 1, 128)
    params = _block_params(layer, 3, x)
    want = jax.jit(lambda p, x, m: layer.apply(
        {'params': p}, x, key_valid_mask=m))(params, x, mask)
    port = fusion.TransformerEncoderBlock(128, 1, 128, 1)
    port.load_state_dict(_sub(state_from_flax(
        {'fuse': {'visual_encoder': {'layer0': params}}}, {}),
        'fuse.visual_encoder.'), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)

    feats = {'a': rng.normal(size=(B, T, 8)).astype(np.float32),
             'b': rng.normal(size=(B, T, 24)).astype(np.float32)}
    gate = jax_fusion.AttentionFusion(('a', 'b'), num_out_feats=128)
    params = _block_params(gate, 4, feats)
    want = jax.jit(lambda p, f: gate.apply({'params': p}, f))(params, feats)
    port = fusion.AttentionFusion([8, 24], 128)
    port.load_state_dict(_sub(state_from_flax({'fuse': params}, {}),
                              'fuse.'), strict=True)
    with torch.no_grad():
        got = port([torch.from_numpy(feats['a']),
                    torch.from_numpy(feats['b'])])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize('name', ['JMT', 'MT'])
def test_joint_fusion_at_two_rows_is_fvt_tpus(name):
    """B = 2 with row 1 padded: the final attention runs over the 2*T
    flattened frames, mixing the rows, in both."""
    rng = np.random.default_rng(5)
    visual = rng.normal(size=(B, T, 128)).astype(np.float32)
    audio = rng.normal(size=(B, T, 8)).astype(np.float32)
    block = (jax_fusion.JMTFusion if name == 'JMT' else jax_fusion.MTFusion)()
    params = _block_params(block, 6, visual, audio)
    port = fusion.JointFusion(8, joint=name == 'JMT')
    port.load_state_dict(_sub(state_from_flax({'fuse': params}, {}),
                              'fuse.'), strict=True)
    apply = jax.jit(lambda p, v, a, m: block.apply(
        {'params': p}, v, a, time_mask=m))
    for mask in (None, _mask()):
        # fvt_tpu takes no mask as a mask of every frame: one compile
        want = apply(params, visual, audio,
                     _mask((T, T)) if mask is None else mask)
        with torch.no_grad():
            got = port(torch.from_numpy(visual), torch.from_numpy(audio),
                       None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    # the rows mix: row 0's output moves with row 1's frames
    audio2 = audio.copy()
    audio2[1] += 1.0
    with torch.no_grad():
        moved = port(torch.from_numpy(visual), torch.from_numpy(audio2))
    assert not np.allclose(moved[0].numpy(), got[0].numpy(), atol=1e-3)


# ------------------------------------------------------------ the families
@pytest.fixture(scope='module')
def narrow():
    """fvt_tpu's three families on narrow TCNs (video as features), their
    variables and the port's models loaded from them."""
    x = {k: v[:1, :8] for k, v in _inputs().items()}
    out = {}
    for i, name in enumerate(FAMILIES):
        model = _jax_family(name)
        params, stats = flax_variables(model, x, 10 + i)
        port = _port_family(name)
        missing, unexpected = port.load_state_dict(
            state_from_flax(params, stats, MODS), strict=False)
        assert not unexpected and all(k.startswith('spatial.')
                                      for k in missing)
        out[name] = (_jax_eval(model, name), params, stats, port)
    return out


def _jax_eval(model, name):
    """fvt_tpu's eval forward, jitted once (applied op by op, a JMT took
    seconds to dispatch): fn(params, stats, x, mask) -> logits.  A JMT or
    MT takes no mask as a mask of every frame, the same logits from one
    compile."""
    def apply(p, s, x, mask):
        kw = {} if mask is None else {'time_mask': mask}
        return model.apply({'params': p, 'batch_stats': s}, x, train=False,
                           **kw)
    fn = jax.jit(apply)

    def run(p, s, x, mask):
        if mask is None and name != 'CAN':
            mask = np.ones(x['vggish'].shape[:2], bool)
        return fn(p, s, x, mask)
    return run


def _jax_logits(fn, params, stats, x, mask=None):
    return np.asarray(fn(params, stats, x, mask))


@pytest.mark.parametrize('name', FAMILIES)
def test_eval_logits_are_fvt_tpus(narrow, name):
    model, params, stats, port = narrow[name]
    x = _inputs(7)
    masks = [None] if name == 'CAN' else [None, _mask()]
    for mask in masks:
        want = _jax_logits(model, params, stats, x, mask)
        kw = {} if mask is None else {'time_mask': torch.from_numpy(mask)}
        with torch.inference_mode():
            got = port(_torch(x), **kw).numpy()
        assert got.shape == (B, T, 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize('name', ['JMT', 'MT'])
def test_padding_leaves_the_valid_prefix(narrow, name):
    """A row padded from 7 to T frames and masked gives the 7-frame row's
    logits on its first 7 frames (fvt_tpu's ragged bs=1 eval)."""
    port = narrow[name][3]
    x = _inputs(8, b=1)
    short = {k: v[:, :LENGTHS[1]] for k, v in x.items()}
    padded = {k: np.concatenate([v[:, :LENGTHS[1]],
                                 np.zeros_like(v[:, LENGTHS[1]:])], axis=1)
              for k, v in x.items()}
    with torch.inference_mode():
        want = port(_torch(short)).numpy()
        got = port(_torch(padded), time_mask=torch.from_numpy(
            _mask((LENGTHS[1],)))).numpy()
    np.testing.assert_allclose(got[:, :LENGTHS[1]], want, rtol=0, atol=ATOL)


@pytest.fixture(scope='module')
def arcface():
    """A flax ArcFace's variables (numpy-filled, BatchNorms and PReLU off
    their init values) and its embeddings of two 40^2 frames."""
    crops = np.random.default_rng(9).uniform(
        -1, 1, (1, 2, 40, 40, 3)).astype(np.float32)
    params, stats = flax_variables(FlaxVisualBackbone(),
                                   jnp.zeros((1, 40, 40, 3)), 11)
    emb = jax.jit(lambda p, s, x: FlaxVisualBackbone().apply(
        {'params': p, 'batch_stats': s}, x, train=False))(
        params, stats, crops[0])
    return params, stats, crops, np.asarray(emb)[None]


@pytest.fixture(scope='module')
def with_backbone(narrow, arcface):
    """Each family's narrow flax variables with the ArcFace added, and the
    port's model loaded from them with ``strict=True``."""
    arc_params, arc_stats, _, _ = arcface
    out = {}
    for name in FAMILIES:
        _, params, stats, _ = narrow[name]
        params = {**params, 'spatial_video': arc_params}
        stats = {**stats, 'spatial_video': arc_stats}
        port = _port_family(name)
        port.load_state_dict(state_from_flax(params, stats, MODS),
                             strict=True)
        out[name] = (params, stats, port)
    return out


@pytest.mark.parametrize('name', FAMILIES)
def test_raw_frames_through_the_ir50(narrow, arcface, with_backbone, name):
    fn, params, stats, _ = narrow[name]
    _, _, crops, emb = arcface
    port = with_backbone[name][2]
    x = {k: v[:1, :2] for k, v in _inputs(12).items()}
    want = _jax_logits(fn, params, stats, {**x, 'video': emb})
    with torch.inference_mode():
        got = port(_torch({**x, 'video': crops})).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_eval_backbone_in_chunks_equals_one_pass(with_backbone):
    """``eval_frames`` bounds the frames of one backbone call; the eval
    backbone is per frame, so the embeddings do not change."""
    model = with_backbone['CAN'][2]
    crops = torch.from_numpy(np.random.default_rng(13).uniform(
        -1, 1, (1, 5, 40, 40, 3)).astype(np.float32))
    calls = []
    hook = model.spatial.visual.register_forward_pre_hook(
        lambda m, a: calls.append(a[0].shape[0]))
    try:
        with torch.inference_mode():
            want = model.encode_video({'video': crops}, False, None, False)
            model.eval_frames = 2
            got = model.encode_video({'video': crops}, False, None, False)
    finally:
        model.eval_frames = None
        hook.remove()
    assert calls == [5, 2, 2, 1]
    np.testing.assert_allclose(got['video'].numpy(), want['video'].numpy(),
                               rtol=0, atol=1e-6)


# ------------------------------------------------------- upstream weights
@pytest.mark.parametrize('name', FAMILIES)
def test_upstream_state_dict_loads_with_its_dead_keys(narrow, with_backbone,
                                                      name):
    """fvt_tpu's exporter (``can_to_torch`` / ``jmt_to_torch``, which
    ``export_state_dict`` calls at the published widths) writes the
    upstream model's keys; dropping the family's dead keys, and no others,
    loads them with ``strict=True`` and gives fvt_tpu's logits."""
    from fvt_tpu.models.torch_export import can_to_torch, jmt_to_torch

    fn, narrow_params, narrow_stats, _ = narrow[name]
    params, stats, port = with_backbone[name]
    upstream = (can_to_torch(params, stats, MODS, SETTINGS) if name == 'CAN'
                else jmt_to_torch(params, stats, MODS, SETTINGS,
                                  joint=name == 'JMT'))
    dead = {k for k in upstream if is_dead_key(k, name)}
    family_dead = {'CAN': 'conv_c.', 'MT': 'fuse.reduce_feats_dim.'}
    assert {k for k in dead if not (k.startswith('spatial.visual.logits')
                                    or '.net.' in k)} == {
        k for k in upstream if name in family_dead
        and k.startswith(family_dead[name])}
    if name == 'JMT':
        assert 'fuse.reduce_feats_dim.weight' in upstream
    port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                          for k, v in upstream.items() if k not in dead},
                         strict=True)
    x = _inputs(14)
    want = _jax_logits(fn, narrow_params, narrow_stats, x)
    with torch.inference_mode():
        got = port(_torch(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# ------------------------------------------------------------ best models
@pytest.mark.parametrize('name', FAMILIES)
def test_best_model_bytes_are_flaxs(narrow, tmp_path, name):
    """The writer gives flax's bytes and the reader (``load_best_model``'s
    ``read_flax_variables`` + ``state_from_flax``) the state back bit for
    bit.  The ArcFace subtree of such a file is held in
    tests/test_torch_train_video_step.py."""
    from flax import serialization
    from fvt_tpu_torch.models.checkpoint import (read_flax_variables,
                                                 save_best_model)

    _, params, stats, port = narrow[name]
    want = serialization.to_bytes(
        {'params': jax.tree.map(np.asarray, params),
         'batch_stats': jax.tree.map(np.asarray, stats)})
    state = {k: v for k, v in port.state_dict().items()
             if not k.startswith('spatial.')}
    path = str(tmp_path / 'model.msgpack')
    save_best_model(state, path, MODS)
    with open(path, 'rb') as f:
        assert f.read() == want
    loaded = state_from_flax(*read_flax_variables(path), MODS)
    assert set(loaded) == set(state)
    for k, v in state.items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(loaded[k], v), k
