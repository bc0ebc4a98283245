"""Data-parallel serving of one artifact (``ServingArtifact.call_sharded``,
``fvt_tpu_torch/parallel/serving.py``) over two ``gloo`` ranks on the CPU,
against ``fvt_tpu``'s ``call_sharded`` over ``make_mesh(2)``.

* Library: one 2-rank group for the file (``parallel.mesh.spawn`` running
  ``tests/torch_serving_worker.py``; rank 0 calls, rank 1 follows):
  - a full-width ``vggish+bert`` LFAN that ``fvt_tpu`` exported, served by
    the port within ATOL / RTOL of ``fvt_tpu``'s ``call_sharded`` on the
    same artifact, argmaxes equal; a batch of 3 rows refused ("divide");
  - an MT (``video+vggish``) artifact of the port with lengths [8, 5, 8,
    3] (``fvt_tpu``'s ``tests/test_export_serving.py:228-258``) against
    ``fvt_tpu``'s eval step jitted with the batch sharded over
    ``make_mesh(2)``, as its ``call_sharded`` jits its export (the video
    as the port's ArcFace embeddings of the same crops: an ``fvt_tpu``
    artifact of a video model would compile the IR-50 here): the final
    attention spans both ranks' rows and masks;
  - a dynamic int8 LFAN: the 41 per-conv scales of the sharded call, on
    both ranks, equal the single call's bit for bit (the amax is reduced
    over the ranks), the logits within ATOL / RTOL of it.
* HTTP: ``serve_http.build_server(..., mesh_devices=2)`` on the CPU:
  ``/healthz`` says mesh 2, ``/logits`` within ATOL / RTOL of ``fvt_tpu``'s
  live eval step, a stream's window batches (``streaming``'s batcher with
  the mesh) within them of the offline stitch of single calls, a batch
  of 3 rows answered 400; drain stops the follower.
* ``infer_artifact --mesh 2``: per-video logits within ATOL / RTOL of the
  run without it (``fvt_tpu``'s mesh leg, ``tests/test_export_serving.py:
  585-595``).

ATOL / RTOL are ``fvt_tpu``'s own for its sharded call (float32 sums in
another order).  No process outlives its test: every spawn and group has
a timeout, and each leg checks its children have ended.
"""
import multiprocessing
import os
import pickle
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from fvt_tpu import export as jax_export
from fvt_tpu.config.defaults import get_config as jax_get_config
from fvt_tpu.models.registry import init_model as jax_init_model
from fvt_tpu.parallel.mesh import make_mesh
from fvt_tpu.train.steps import make_eval_step
from fvt_tpu_torch import constants, export
from fvt_tpu_torch.client import ServingClient, ServingError
from fvt_tpu_torch.config import flat_yaml
from fvt_tpu_torch.config.defaults import get_config, to_namespace
from fvt_tpu_torch.data import windowing as W
from fvt_tpu_torch.data.transforms import eval_video_transform
from fvt_tpu_torch.models.checkpoint import save_best_model
from fvt_tpu_torch.models.registry import init_model
from fvt_tpu_torch.models.to_jax import flax_from_state
from fvt_tpu_torch.parallel import mesh
from fvt_tpu_torch.tools import export_serving, infer_artifact, serve_http
from fvt_tpu_torch.tools.synth_store import make_cexpr_store

import torch_serving_worker as worker

WINDOW, HOP, WB = 8, 4, 4
ATOL, RTOL = 2e-5, 1e-5
SPAWN_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores (the
    followers take the caller's count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(specs, rows=None, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in specs.items():
        shape = list(v['shape'])
        shape[0] = rows or shape[0]
        out[k] = (rng.integers(0, 256, shape, dtype=np.uint8)
                  if v['dtype'] == 'uint8'
                  else rng.standard_normal(shape, dtype=np.float32))
    return out


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _jax_args(name, modality, **kw):
    cfg = jax_get_config('MELD')
    cfg.update(model_name=name, modality=f'{modality}+EXPR_continuous_label',
               window_length=WINDOW, hop_length=HOP, eval_window_batch=WB,
               **kw)
    return SimpleNamespace(**cfg)


def _port_cfg(name, modality, **kw):
    cfg = get_config('MELD')
    cfg.update(model_name=name, modality=f'{modality}+EXPR_continuous_label',
               window_length=WINDOW, hop_length=HOP, eval_window_batch=WB,
               verbose=False)
    cfg.update(kw)
    return cfg


def _draw_statistics(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(torch.from_numpy(rng.normal(
                    0, 0.1, buf.shape).astype(np.float32)))
            elif name.endswith('running_var'):
                buf.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, buf.shape).astype(np.float32)))


@pytest.fixture(scope='module')
def jax_lfan(tmp_path_factory):
    """A full-width ``vggish+bert`` LFAN exported by ``fvt_tpu`` at (4, 8)
    and (3, 8) on numpy-filled weights: (args, model, params, stats,
    path)."""
    args = _jax_args('LFAN', 'vggish+bert')
    model = jax_init_model(args)
    specs = jax_export.serving_input_specs(args, WB, WINDOW)
    inputs = {k: np.zeros(s.shape, s.dtype) for k, s in specs.items()}
    shapes = jax.eval_shape(lambda k: model.init(k, inputs, train=False),
                            jax.random.key(0))
    rng = np.random.default_rng(2)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ('var', 'scale', 'g'):
            a = rng.uniform(0.5, 1.5, shape)
        elif name in ('kernel', 'v'):
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            a = rng.normal(0, 0.05, shape)
        return a.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    params, stats = variables['params'], variables['batch_stats']
    exports, aot, meta = jax_export.export_serving(
        model, 'LFAN', args, params, stats, shapes=[(WB, WINDOW),
                                                    (WB - 1, WINDOW)],
        platforms=['cpu'])
    path = str(tmp_path_factory.mktemp('jax_lfan') / 'lfan.fvtserve')
    jax_export.save_artifact(path, exports, aot, meta, params, stats)
    return args, model, params, stats, path


def _port_artifact(root, name, modality, shape, seed, **kw):
    """(path, model, the input specs at ``shape``) of a port artifact."""
    cfg = _port_cfg(name, modality, **kw)
    model = init_model(to_namespace(cfg))
    _draw_statistics(model, seed)
    path = os.path.join(root, f'{name}-{kw.get("serve_quant", "f32")}'
                              f'.fvtserve')
    meta = export.build_meta(to_namespace(cfg), [shape])
    export.save_artifact(path, meta, model)
    return path, model, next(iter(meta['shapes'].values()))['inputs']


@pytest.fixture(scope='module')
def library(tmp_path_factory, jax_lfan):
    """The 2-rank group's results ({case: rank 0's}, {case: rank 1's}) and
    the cases."""
    root = str(tmp_path_factory.mktemp('sharded'))
    args, _, _, _, lfan_path = jax_lfan
    lfan_specs = {k: {'shape': list(s.shape), 'dtype': str(s.dtype)}
                  for k, s in jax_export.serving_input_specs(
                      args, WB, WINDOW).items()}
    mt_path, mt, mt_specs = _port_artifact(root, 'MT', 'video+vggish',
                                           (WB, WINDOW), 7)
    int8_path, _, int8_specs = _port_artifact(root, 'LFAN', 'video+vggish',
                                              (2, 4), 9, serve_quant='int8')
    cases = {
        'lfan': (lfan_path, args, _batch(lfan_specs, seed=12), None,
                 _batch(lfan_specs, rows=WB - 1, seed=13)),
        'mt': (mt_path, None, _batch(mt_specs, seed=14),
               np.array([8, 5, 8, 3], np.int32), None),
        'int8': (int8_path, None, _batch(int8_specs, seed=15), None, None)}
    out = os.path.join(root, 'ranks.pkl')
    mesh.spawn(worker.run_cases, 2, cases, out, timeout_s=SPAWN_TIMEOUT_S)
    ranks = [pickle.load(open(f'{out}.{r}', 'rb')) for r in range(2)]
    return ranks, cases, mt.eval()


def test_lfan_call_sharded_matches_fvt_tpus(jax_lfan, library):
    (rank0, rank1), cases, _ = library
    batch = cases['lfan'][2]
    want = jax_export.load_artifact(jax_lfan[4]).call_sharded(
        batch, mesh=make_mesh(2))
    _close(rank0['lfan']['sharded'], want)
    _close(rank0['lfan']['single'], want)
    assert rank1['lfan']['calls'] == 1
    assert 'must divide' in rank0['lfan']['odd']


def test_masked_mt_call_sharded_matches_fvt_tpus(library):
    """Fails where the final attention takes this rank's mask against the
    gathered rows (a key mask of half the timeline)."""
    (rank0, _), cases, mt = library
    batch, length = cases['mt'][2], cases['mt'][3]
    with torch.inference_mode():
        crops = eval_video_transform(torch.from_numpy(batch['video']))
        feats = mt.encode_video({'video': crops}, False, None,
                                False)['video'].numpy()
    params, stats = flax_from_state(
        {k: v for k, v in mt.state_dict().items()
         if not k.startswith('spatial.')}, mt.modality)
    m = make_mesh(2)
    shard = NamedSharding(m, PartitionSpec(m.axis_names[0]))
    repl = NamedSharding(m, PartitionSpec())
    jax_in = {'video': feats, 'vggish': batch['vggish']}
    step = jax.jit(make_eval_step(jax_init_model(_jax_args('MT',
                                                           'video+vggish')),
                                  needs_time_mask=True),
                   in_shardings=(repl, repl, {k: shard for k in jax_in},
                                 shard), out_shardings=shard)
    want = np.asarray(step(params, stats, jax_in, length))
    got = rank0['mt']['sharded']
    _close(got, want)
    # the mask shapes the result beyond the tolerance
    full = np.asarray(step(params, stats, jax_in, np.full(WB, WINDOW,
                                                          np.int32)))
    assert not np.allclose(got, full, atol=ATOL, rtol=RTOL)


def test_dynamic_int8_scales_span_the_sharded_call(library):
    (rank0, rank1), _, _ = library
    res = rank0['int8']
    for scales in (res['sharded_scales'], rank1['int8']['scales']):
        assert len(scales) == 41 == len(res['single_scales'])
        assert all(torch.equal(a, b) for a, b in
                   zip(scales, res['single_scales']))
    _close(res['sharded'], res['single'])


def test_indivisible_rows_and_no_group_are_refused(jax_lfan):
    art = export.load_artifact(jax_lfan[4], device='cpu', config=jax_lfan[0])
    batch = _batch(art.shape_specs['b4xt8'], seed=16)
    with pytest.raises(AssertionError, match='divide'):
        art.call_sharded(batch, mesh=mesh.World(0, 3, 0, torch.device('cpu'),
                                                'gloo'))
    with pytest.raises(RuntimeError, match='no process group'):
        art.call_sharded(batch)


def test_http_mesh_2(jax_lfan):
    args, model, params, stats, path = jax_lfan
    srv = serve_http.build_server(path, port=0, device='cpu', mesh_devices=2,
                                  config=args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    client = ServingClient(f'http://127.0.0.1:{srv.server_port}', timeout=60)
    try:
        health = client.healthz()
        assert health['ok'] and health['mesh'] == 2
        specs = srv.artifact.shape_specs
        batch = _batch(specs['b4xt8'], seed=17)
        _close(client.logits(batch),
               np.asarray(make_eval_step(model)(params, stats, batch)))
        # a stream's window batches (fvt_tpu_torch.streaming) through
        # call_sharded too: the offline stitch of single calls
        frames = {k: v[0] for k, v in _batch(
            {k: dict(v, shape=[1, 21] + v['shape'][2:])
             for k, v in specs['b4xt8'].items()}, seed=19).items()}
        idx = W.window_index_matrix(21, WINDOW, HOP)
        rows = np.concatenate([idx, idx[-1:].repeat(-len(idx) % WB, 0)])
        want = np.concatenate([srv.artifact.call(
            {k: v[rows[i:i + WB]] for k, v in frames.items()})
            for i in range(0, len(rows), WB)])[:len(idx)]
        _close(client.stream(frames, chunk=5),
               W.stitch_windows_np(want, idx, 21))
        with pytest.raises(ServingError, match='divide') as e:
            client.logits(_batch(specs['b3xt8'], seed=18))
        assert e.value.code == 400
    finally:
        procs = srv.group.procs
        serve_http.drain_and_shutdown(srv, timeout_s=5)
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert [p.exitcode for p in procs] == [0]
    assert not multiprocessing.active_children()


def test_infer_artifact_mesh_2(tmp_path):
    store = make_cexpr_store(str(tmp_path / 'store'), [5, 13, 21])
    cfg = _port_cfg('LFAN', 'vggish+bert', eval_bucket_quantum=WINDOW,
                    eval_window_batch=2)
    run = str(tmp_path / 'run')
    os.makedirs(os.path.join(run, 'best-models', 'case'))
    flat_yaml.dump(cfg, os.path.join(run, 'config.yml'))
    model = init_model(to_namespace(cfg))
    save_best_model(model, os.path.join(run, 'best-models', 'case',
                                        'model.msgpack'), model.modality)
    path = export_serving.main(['--fd_exp', run])['artifact']
    argv = ['--mode', 'EVALUATION', '--fd_exp', run, '--dataset_path',
            store['dataset_path'], '--folds_dir', store['folds_dir'],
            '--artifact', path]
    got = {}
    for mesh_n in (0, 2):
        outd = str(tmp_path / f'mesh{mesh_n}')
        extra = ['--mesh', str(mesh_n)] if mesh_n else []
        got[mesh_n] = infer_artifact.main(argv + ['--outd', outd] + extra,
                                          device='cpu')[1]
        with open(os.path.join(outd, f'pred-{constants.C_EXPR_DB_CHALLENGE}',
                               'prediction.pkl'), 'rb') as f:
            assert list(pickle.load(f)) == list(got[mesh_n])
    assert not multiprocessing.active_children()
    assert list(got[2]) == list(got[0]) and len(got[0]) == 3
    for trial, rec in got[0].items():
        np.testing.assert_array_equal(got[2][trial]['labels'], rec['labels'])
        _close(got[2][trial]['logits'], rec['logits'])
