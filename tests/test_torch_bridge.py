"""Weight bridge and server tests of the port, on narrow feature-only LFANs.

* ``from_jax.state_from_flax`` agrees with
  ``fvt_tpu.models.torch_export.lfan_to_torch`` on every key the port has,
  and lacks only the dead keys; the port's LFAN loaded from it matches the
  flax LFAN in eval mode (fp32, rtol 2e-4 / atol 2e-5).  The ArcFace keys
  are checked in tests/test_torch_lfan_serving.py on its shared fixture.
* ``fvt_tpu.streaming`` serves a CPU ``ServingModel`` unchanged: streamed
  logits equal the offline stitch within 1e-5 for streams shorter and
  longer than the window, each chunked two ways, and through a registry
  that batches windows of several streams together.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvt_tpu.data import windowing as W
from fvt_tpu.models.models import LFAN as FlaxLFAN
from fvt_tpu.models.torch_export import lfan_to_torch
from fvt_tpu.streaming import StreamingRegistry, StreamingSession
from fvt_tpu_torch.models.from_jax import is_dead_key, state_from_flax
from fvt_tpu_torch.models.models import LFAN
from fvt_tpu_torch.serve import ServingModel, lfan_serving_forward

MODS = ('vggish', 'bert')
TCN = {'vggish': [16, 16, 8, 8], 'bert': [24, 24, 16, 16]}
ENC = {m: c[-1] for m, c in TCN.items()}
DIMS = {'vggish': 128, 'bert': 768}
WINDOW, HOP, WB = 12, 8, 2


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
        return leaf
    return jax.tree_util.tree_map_with_path(move, tree)


@pytest.fixture(scope='module')
def narrow():
    rng = np.random.default_rng(0)
    model = FlaxLFAN(modality=MODS, output_dim=7, tcn_channel=TCN,
                     encoder_dim=ENC)
    x = {m: jnp.zeros((1, 8, DIMS[m])) for m in MODS}
    variables = model.init(jax.random.key(0), x, train=False)
    params = _perturb(variables['params'], rng, stats=False)
    stats = _perturb(variables['batch_stats'], rng, stats=True)
    return model, params, stats


def test_bridge_agrees_with_torch_export(narrow):
    _, params, stats = narrow
    want = lfan_to_torch(params, stats, MODS, TCN, DIMS)
    got = state_from_flax(params, stats, MODS)
    missing = set(want) - set(got)
    assert missing and all(is_dead_key(k) for k in missing)
    assert {k.rsplit('.', 2)[0].rsplit('.', 1)[-1] for k in missing} \
        == {'net'}
    assert set(got) <= set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_bridged_lfan_matches_flax(narrow):
    model, params, stats = narrow
    rng = np.random.default_rng(1)
    x = {m: rng.normal(size=(2, 20, DIMS[m])).astype(np.float32)
         for m in MODS}
    want = model.apply({'params': params, 'batch_stats': stats},
                       {m: jnp.asarray(v) for m, v in x.items()},
                       train=False)
    port = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC,
                embedding_dim=DIMS)
    port.load_state_dict(state_from_flax(params, stats, MODS),
                         strict=True)
    got = lfan_serving_forward(port, {m: torch.from_numpy(v)
                                      for m, v in x.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


@pytest.fixture(scope='module')
def server():
    model = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC,
                 embedding_dim=DIMS,
                 generator=torch.Generator().manual_seed(3))
    return ServingModel(model, WB, WINDOW, HOP, 'cpu')


def _stream(n, seed):
    rng = np.random.default_rng(seed)
    return {m: rng.normal(size=(n, DIMS[m])).astype(np.float32)
            for m in MODS}


def _offline(server, frames, n):
    if n < WINDOW:
        idx = W.pad_short_window_indices(n, WINDOW)[None]
    else:
        idx = W.window_index_matrix(n, WINDOW, HOP)
    out = lfan_serving_forward(server.model, {
        m: torch.from_numpy(v[idx]) for m, v in frames.items()}).numpy()
    return out[0, :n] if n < WINDOW else W.stitch_windows_np(out, idx, n)


# 7 frames: one pad-by-repeat window; 30 frames: windows 0, 8, 16 and
# the tail window 18
@pytest.mark.parametrize('n,chunk', [(7, 1), (7, 3), (30, 4), (30, 11)])
def test_streaming_session_matches_offline_stitch(server, n, chunk):
    frames = _stream(n, seed=n)
    sess = StreamingSession(server)
    parts = [sess.feed({m: v[c:c + chunk] for m, v in frames.items()})
             for c in range(0, n, chunk)]
    parts.append(sess.close())
    starts = np.cumsum([0] + [len(p[1]) for p in parts])[:-1]
    assert [p[0] for p in parts if len(p[1])] \
        == [s for s, p in zip(starts, parts) if len(p[1])]
    got = np.concatenate([p[1] for p in parts])
    assert got.shape == (n, 7)
    np.testing.assert_allclose(got, _offline(server, frames, n), rtol=0,
                               atol=1e-5)


def test_registry_batches_streams_together(server):
    lengths = (7, 30, 27)
    streams = {n: _stream(n, seed=100 + n) for n in lengths}
    reg = StreamingRegistry(server, dynamic_batch=True)
    sids = {n: reg.open() for n in lengths}
    got = {n: [] for n in lengths}
    for c in range(0, max(lengths), 5):
        for n, frames in streams.items():
            if c < n:
                chunk = {m: v[c:c + 5] for m, v in frames.items()}
                got[n].append(reg.feed(sids[n], chunk)[1])
    pending = []
    for n in lengths:  # tails join the shared queue without a flush
        _, logits, done = reg.finish(sids[n])
        got[n].append(logits)
        if not done:
            pending.append(n)
    reg.drain()
    for n in pending:
        _, logits, done = reg.poll(sids[n])
        assert done
        got[n].append(logits)
    assert reg.live_sessions == 0
    # 1 + 4 + 3 windows of three streams in four full batches of 2
    assert (reg.batcher.dispatches, reg.batcher.rows_padded) == (4, 0)
    for n, frames in streams.items():
        np.testing.assert_allclose(np.concatenate(got[n]),
                                   _offline(server, frames, n), rtol=0,
                                   atol=1e-5)


def test_serving_model_meta_and_refusals(server):
    meta = server.meta
    assert meta['needs_mask'] is False and meta['num_classes'] == 7
    assert (meta['window_length'], meta['hop_length']) == (WINDOW, HOP)
    spec = meta['shapes'][f'b{WB}xt{WINDOW}']
    assert spec['inputs']['bert'] == {'shape': [WB, WINDOW, 768],
                                      'dtype': 'float32'}
    good = {m: np.zeros((WB, WINDOW, DIMS[m]), np.float32) for m in MODS}
    assert server.call(good).shape == (WB, WINDOW, 7)
    with pytest.raises(ValueError, match='time mask'):
        server.call(good, length=np.full(WB, WINDOW, np.int32))
    with pytest.raises(ValueError, match='bert'):
        server.call(dict(good, bert=np.zeros((WB, WINDOW, 3), np.float32)))
