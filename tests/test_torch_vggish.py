"""The port's VGGish (``fvt_tpu_torch/models/vggish.py``) against
``fvt_tpu``'s, on the CPU.

The VGGish has one width (72.1 M parameters), so the tests run it on few
log-mel patches (6, drawn from a numpy seed), its weights filled with
numpy by leaf name in ``fvt_tpu``'s tree and carried over with
``from_jax.vggish_state_from_flax``; ``fvt_tpu``'s is jitted once per
compute type for the module.

* float32 embeddings within 1e-4 of ``fvt_tpu``'s largest magnitude;
* bfloat16 (``--amp``): within twice ``fvt_tpu``'s own bf16-vs-fp32
  distance, as ``tests/test_torch_arcface_bf16.py`` holds the ArcFace;
* the flatten order: the port permutes its activations to (N, H, W, C)
  before ``fc0``, so an upstream state_dict (``fvt_tpu``'s
  ``vggish_to_torch``, a plain transpose of ``fc0``) loads with
  ``strict=True`` and gives ``fvt_tpu``'s embeddings; a model that
  flattened NCHW would load it too and compute something else;
* the bridge both ways, exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvt_tpu.models.torch_export import vggish_to_torch
from fvt_tpu.models.vggish import VGGish as FlaxVGGish
from fvt_tpu_torch.models.from_jax import vggish_state_from_flax
from fvt_tpu_torch.models.to_jax import vggish_flax_from_state
from fvt_tpu_torch.models.vggish import VGGish

N = 6
RTOL = 1e-4
BF16_PATHS_APART = 2.0


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The suite runs six workers on the machine's cores; torch's intra-op
    threads, each spinning across them, made small CPU runs tens of times
    slower there.  One thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vggish_params(seed: int) -> dict:
    """``fvt_tpu`` VGGish params, drawn with numpy by leaf name: kernels
    scaled by their fan-in, biases about 0."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda k: FlaxVGGish().init(k, jnp.zeros((1, 96, 64))),
        jax.random.key(0))['params']

    def fill(path, leaf):
        if path[-1].key == 'kernel':
            a = rng.standard_normal(leaf.shape, np.float32)
            return a / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return rng.normal(0, 0.05, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def patches(seed: int = 1, n: int = N) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(n, 96, 64)).astype(np.float32)


@pytest.fixture(scope='module')
def ref():
    """fvt_tpu's embeddings of :func:`patches` in float32 and bfloat16."""
    params = vggish_params(0)
    x = jnp.asarray(patches())
    out = {}
    for name, dtype in (('fp32', jnp.float32), ('bf16', jnp.bfloat16)):
        model = FlaxVGGish(dtype=dtype)
        out[name] = np.asarray(jax.jit(
            lambda p, x: model.apply({'params': p}, x))(params, x))
    return params, out


def _port(params, dtype=torch.float32) -> VGGish:
    model = VGGish(dtype)
    model.load_state_dict(vggish_state_from_flax(params), strict=True)
    return model


def _embed(model, x=None) -> np.ndarray:
    with torch.inference_mode():
        return model(torch.from_numpy(patches() if x is None else x)).numpy()


def test_float32_embeddings_are_fvt_tpus(ref):
    params, want = ref
    got = _embed(_port(params))
    assert got.shape == (N, 128) and got.dtype == np.float32
    scale = np.abs(want['fp32']).max()
    assert np.abs(got - want['fp32']).max() <= RTOL * scale


def test_bfloat16_is_within_twice_fvt_tpus_own_distance(ref):
    params, want = ref
    got = _embed(_port(params, torch.bfloat16))
    assert got.dtype == np.float32
    own = np.abs(want['bf16'] - want['fp32']).max()
    assert own > 0
    err = np.abs(got - want['bf16']).max()
    assert err <= BF16_PATHS_APART * own, (err, own)
    # the parameters stay float32: bfloat16 is a compute type
    assert {p.dtype for p in _port(params, torch.bfloat16).parameters()} \
        == {torch.float32}


def test_upstream_state_dict_loads_strictly_and_gives_fvt_tpus(ref):
    params, want = ref
    upstream = {}
    vggish_to_torch(params, upstream)
    model = VGGish()
    assert set(upstream) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in upstream.items()}, strict=True)
    got = _embed(model)
    assert np.abs(got - want['fp32']).max() \
        <= RTOL * np.abs(want['fp32']).max()


def test_flatten_is_nhwc():
    """fc0's input column h*2048 + w*512 + c reads channel c of pooled
    cell (h, w): a one-hot fc0 row picks exactly that activation."""
    model = VGGish()
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(patches(n=2))
    feats = x[:, None]
    with torch.no_grad():
        for mod in model.features:
            feats = mod(feats)
        assert feats.shape == (2, 512, 6, 4)
        h, w, c = 4, 1, 300
        fc0 = model.embeddings[0]
        fc0.weight.zero_()
        fc0.bias.zero_()
        fc0.weight[0, h * 4 * 512 + w * 512 + c] = 1.0
        taps = {}
        fc0.register_forward_hook(lambda m, a, out: taps.setdefault('o',
                                                                    out))
        model(x)
    torch.testing.assert_close(taps['o'][:, 0], feats[:, c, h, w],
                               rtol=0, atol=0)


def test_bridge_both_ways_is_exact(ref):
    params, _ = ref
    state = vggish_state_from_flax(params, 'spatial.audio.backbone')
    back = vggish_flax_from_state(state, 'spatial.audio.backbone')
    assert sorted(back) == sorted(params)
    for layer, leaves in params.items():
        assert sorted(back[layer]) == sorted(leaves)
        for name, leaf in leaves.items():
            np.testing.assert_array_equal(back[layer][name],
                                          np.asarray(leaf))
    with pytest.raises(KeyError, match='no counterpart'):
        vggish_flax_from_state({**state, 'spatial.audio.backbone.x': state[
            'spatial.audio.backbone.features.0.bias']},
            'spatial.audio.backbone')


def test_eval_in_chunks_is_one_pass(ref):
    """The model's eval runs the VGGish over ``eval_frames`` patches at a
    time: chunked or whole, the same embeddings."""
    from fvt_tpu_torch.models.models import LFAN

    params, _ = ref
    tcn = {'logmel': [8, 4], 'bert': [8, 4]}
    model = LFAN(('logmel', 'bert'), 7, tcn_channel=tcn,
                 encoder_dim={'logmel': 4, 'bert': 4})
    model.spatial.audio.backbone.load_state_dict(
        vggish_state_from_flax(params), strict=True)
    x = {'logmel': torch.from_numpy(patches().reshape(2, 3, 96, 64))}
    with torch.inference_mode():
        whole = model.encode_logmel(x, False)['logmel']
        model.eval_frames = 4
        chunked = model.encode_logmel(x, False)['logmel']
        trained = model.encode_logmel(x, True)['logmel']
    assert whole.shape == (2, 3, 128)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)
    torch.testing.assert_close(trained, whole, rtol=0, atol=1e-6)
