"""The port's HTTP serving endpoint (``fvt_tpu_torch/tools/serve_http.py``)
driven through its copy of the numpy-only client (``fvt_tpu_torch/
client.py``) on an ephemeral port, and challenge inference from an
artifact (``fvt_tpu_torch/tools/infer_artifact.py``), on the CPU.

* every endpoint: ``/healthz``, ``/metrics``, ``/meta``, ``/logits``,
  ``/stream/open``, ``/stream/<sid>/feed|poll|finish|close``, an unknown
  path (404), a shape the artifact lacks (400 with its shapes), a body
  that is no npz (400) and a forward that fails (500, as a CUDA error
  would);
* ``/logits`` bit for bit the in-process ``ServingArtifact.call``; a
  stream fed in chunks (the client's loop, and feed / finish / poll by
  hand) bit for bit the offline stitch of in-process calls, a stream
  shorter than the window its pad-by-repeat window's first rows;
* 503 past ``--max_sessions``, 404 after close, drain refusing new opens
  while a live stream finishes;
* a JMT artifact refused for ``--dynamic_batch``, and served per session
  with a length vector (``/logits`` and a stream) bit for bit in process;
* ``tools/infer_artifact.py``'s ``prediction.pkl`` within 1e-5 of
  ``fvt_tpu_torch.inference_challenge``'s on a small challenge store
  (videos shorter and longer than the window).
"""
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from fvt_tpu_torch import constants
from fvt_tpu_torch.client import ServerBusy, ServingClient, ServingError, \
    SessionGone
from fvt_tpu_torch.config import flat_yaml
from fvt_tpu_torch.config.defaults import get_config, to_namespace
from fvt_tpu_torch.data import windowing as W
from fvt_tpu_torch.export import build_meta, save_artifact
from fvt_tpu_torch.inference_challenge import main as challenge_main
from fvt_tpu_torch.models.checkpoint import save_best_model
from fvt_tpu_torch.models.registry import init_model
from fvt_tpu_torch.tools import export_serving, infer_artifact, quickstart, \
    serve_http
from fvt_tpu_torch.tools.synth_store import make_cexpr_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW, HOP, WB = 8, 4, 2
STREAM_LENGTHS = (23, 5, 8)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Under the suite's six workers torch's spinning intra-op threads
    made small CPU runs tens of times slower: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, modality, **kw):
    cfg = get_config('MELD')
    cfg.update(model_name=name, modality=f'{modality}+EXPR_continuous_label',
               window_length=WINDOW, hop_length=HOP, eval_window_batch=WB,
               verbose=False, **kw)
    return cfg


def _artifact(path, name, modality):
    cfg = _cfg(name, modality)
    save_artifact(path, build_meta(to_namespace(cfg), [(WB, WINDOW)]),
                  init_model(to_namespace(cfg)))
    return path


class Served:
    """A server of ``path`` on an ephemeral port in a thread, its client."""

    def __init__(self, path, **kw):
        self.srv = serve_http.build_server(path, device='cpu', **kw)
        self.art = self.srv.artifact
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.client = ServingClient(f'http://127.0.0.1:{self.srv.server_port}',
                                    timeout=60)

    def stop(self) -> int:
        left = serve_http.drain_and_shutdown(self.srv, timeout_s=5)
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()
        return left


@pytest.fixture(scope='module')
def lfan(tmp_path_factory):
    path = _artifact(str(tmp_path_factory.mktemp('lfan') / 'a.fvtserve'),
                     'LFAN', 'vggish+bert')
    served = Served(path, dynamic_batch=True, batch_delay_s=0.05,
                    max_sessions=2)
    yield served
    assert served.stop() == 0


def _frames(spec, n, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.integers(0, 256, (n,) + tuple(v['shape'][2:]),
                             dtype=np.uint8) if v['dtype'] == 'uint8'
                else rng.standard_normal((n,) + tuple(v['shape'][2:]),
                                         dtype=np.float32))
            for k, v in spec.items()}


def _offline(art, frames, length=None):
    """The offline stitch of in-process calls: windows in batches of WB,
    the last repeat-padded; a stream shorter than the window is the first
    rows of its pad-by-repeat window."""
    n = len(next(iter(frames.values())))
    if n < WINDOW:
        idx = W.pad_short_window_indices(n, WINDOW)[None]
    else:
        idx = W.window_index_matrix(n, WINDOW, HOP)
    outs = []
    for s in range(0, len(idx), WB):
        rows = list(idx[s:s + WB])
        rows += [rows[-1]] * (WB - len(rows))
        kw = {} if length is None else {
            'length': np.full(WB, min(n, WINDOW), np.int32)}
        outs.append(art.call({k: v[np.stack(rows)] for k, v in
                              frames.items()}, **kw)[:len(idx) - s])
    logits = np.concatenate(outs)
    return logits[0, :n] if n < WINDOW else W.stitch_windows_np(
        logits, idx, n)


def test_healthz_meta_metrics(lfan):
    health = lfan.client.healthz()
    assert health['ok'] and health['shapes'] == ['b2xt8']
    assert (health['aot'], health['mesh'], health['dynamic_batch']) == \
        (False, 0, True)
    assert lfan.client.meta() == lfan.art.meta
    code, body = lfan.client._request('/metrics')
    assert code == 200
    text = body.decode()
    assert 'fvt_live_sessions' in text
    assert 'fvt_stream_dispatches_total' in text
    assert lfan.client._request('/nowhere')[0] == 404


def test_logits_equal_the_in_process_call(lfan):
    spec = lfan.art.meta['shapes']['b2xt8']['inputs']
    batch = {k: v.reshape([WB, WINDOW] + list(v.shape[1:]))
             for k, v in _frames(spec, WB * WINDOW, 3).items()}
    np.testing.assert_array_equal(lfan.client.logits(batch),
                                  lfan.art.call(batch))
    with pytest.raises(ServingError, match='b2xt8') as e:
        lfan.client.logits({k: v[:1] for k, v in batch.items()})
    assert e.value.code == 400
    health = lfan.client.healthz()
    assert health['latency']['/logits']['count'] == 2
    assert {'p50_ms', 'p99_ms'} <= set(health['latency']['/logits'])


@pytest.mark.parametrize('n', STREAM_LENGTHS)
def test_chunked_stream_is_the_offline_stitch(lfan, n):
    spec = lfan.art.meta['shapes']['b2xt8']['inputs']
    frames = _frames(spec, n, n)
    want = _offline(lfan.art, frames)
    np.testing.assert_array_equal(lfan.client.stream(frames, chunk=3), want)

    handle = lfan.client.open_stream()
    for off in range(0, n, 5):
        handle.feed({k: v[off:off + 5] for k, v in frames.items()})
    handle.finish()
    np.testing.assert_array_equal(handle.result(), want)


def test_a_failed_forward_is_a_server_error(lfan, monkeypatch):
    code, body = lfan.client._request('/logits', b'not an npz', 'POST')
    assert code == 400 and b'malformed npz body' in body

    def failed(*a, **kw):
        raise RuntimeError('CUDA error: an illegal memory access')

    monkeypatch.setattr(lfan.art, 'call', failed)
    spec = lfan.art.meta['shapes']['b2xt8']['inputs']
    batch = {k: v.reshape([WB, WINDOW] + list(v.shape[1:]))
             for k, v in _frames(spec, WB * WINDOW, 4).items()}
    with pytest.raises(ServingError, match='illegal memory') as e:
        lfan.client.logits(batch)
    assert e.value.code == 500


def test_max_sessions_and_closed_sessions(lfan):
    spec = lfan.art.meta['shapes']['b2xt8']['inputs']
    frames = _frames(spec, 6, 9)
    a, b = lfan.client.open_stream(), lfan.client.open_stream()
    with pytest.raises(ServerBusy):
        lfan.client.open_stream()
    assert lfan.client.healthz()['rejected_sessions'] >= 1
    a.feed(frames)
    a.close()
    with pytest.raises(SessionGone):
        a.feed(frames)
    with pytest.raises(SessionGone):
        a.poll()
    c = lfan.client.open_stream()
    for h in (b, c):
        h.close()
    assert lfan.client.healthz()['live_sessions'] == 0


def test_drain_refuses_opens_while_a_stream_finishes(tmp_path):
    path = _artifact(str(tmp_path / 'a.fvtserve'), 'CAN', 'vggish+bert')
    served = Served(path)
    spec = served.art.meta['shapes']['b2xt8']['inputs']
    frames = _frames(spec, 13, 4)
    handle = served.client.open_stream()
    handle.feed(frames)
    assert served.srv.streams.drain() == 1
    with pytest.raises(ServerBusy):
        served.client.open_stream()
    handle.finish()
    np.testing.assert_array_equal(handle.result(),
                                  _offline(served.art, frames))
    assert served.client.healthz()['draining']
    assert served.stop() == 0


def test_jmt_refused_for_dynamic_batch_and_served_with_lengths(tmp_path):
    path = _artifact(str(tmp_path / 'jmt.fvtserve'), 'JMT', 'video+vggish')
    with pytest.raises(ValueError, match='dynamic_batch.*LFAN and CAN'):
        serve_http.build_server(path, device='cpu', dynamic_batch=True)
    served = Served(path)
    try:
        spec = served.art.meta['shapes']['b2xt8']['inputs']
        batch = {k: v.reshape([WB, WINDOW] + list(v.shape[1:]))
                 for k, v in _frames(spec, WB * WINDOW, 5).items()}
        lengths = np.array([WINDOW, 3], np.int32)
        np.testing.assert_array_equal(
            served.client.logits(batch, length=lengths),
            served.art.call(batch, length=lengths))
        frames = _frames(spec, 6, 6)
        np.testing.assert_array_equal(
            served.client.stream(frames, chunk=4),
            _offline(served.art, frames, length=True))
    finally:
        assert served.stop() == 0


def test_infer_artifact_matches_inference_challenge(tmp_path):
    store = make_cexpr_store(str(tmp_path / 'store'), [5, 13, 21])
    cfg = _cfg('LFAN', 'vggish+bert', eval_bucket_quantum=WINDOW)
    run = str(tmp_path / 'run')
    os.makedirs(os.path.join(run, 'best-models', 'case'))
    flat_yaml.dump(cfg, os.path.join(run, 'config.yml'))
    model = init_model(to_namespace(cfg))
    save_best_model(model, os.path.join(run, 'best-models', 'case',
                                        'model.msgpack'), model.modality)
    path = export_serving.main(['--fd_exp', run])['artifact']
    argv = ['--mode', 'EVALUATION', '--fd_exp', run, '--dataset_path',
            store['dataset_path'], '--folds_dir', store['folds_dir']]
    preds = []
    for name, call in (('artifact', lambda a: infer_artifact.main(
            a + ['--artifact', path], device='cpu')),
            ('model', lambda a: challenge_main(a, device='cpu'))):
        outd = str(tmp_path / name)
        call(argv + ['--outd', outd])
        for f in ('eval-test-perf.pkl', 'pred-per-frame-eval-test.pkl',
                  'eval-test-perf.txt'):
            assert os.path.isfile(os.path.join(outd, f)), f
        with open(os.path.join(
                outd, f'pred-{constants.C_EXPR_DB_CHALLENGE}',
                'prediction.pkl'), 'rb') as f:
            preds.append(pickle.load(f))
    got, want = preds
    assert list(got) == list(want) and len(want) == 3
    for trial, rec in want.items():
        np.testing.assert_array_equal(got[trial]['labels'], rec['labels'])
        err = np.abs(got[trial]['logits'] - rec['logits']).max()
        assert err <= 1e-5 * np.abs(rec['logits']).max(), (trial, err)


def test_port_0_is_bound_by_the_server_and_named_in_its_log(tmp_path):
    """``serve_http --port 0`` as ``quickstart`` runs it: the server binds
    a port the system picks (no port is chosen first and bound later, when
    another socket may hold it), names it in its ``serving ... on
    http://127.0.0.1:<port>`` line, which ``quickstart.served_at`` reads
    from the log, and answers /healthz there."""
    path = _artifact(str(tmp_path / 'a.fvtserve'), 'LFAN', 'vggish+bert')
    log_path = str(tmp_path / 'serve_http.log')
    with open(log_path, 'w') as log:
        srv = subprocess.Popen(
            [sys.executable, '-m', 'fvt_tpu_torch.tools.serve_http',
             '--artifact', path, '--port', '0', '--device', 'cpu'],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, 'OMP_NUM_THREADS': '1'})
    try:
        base = None
        for _ in range(240):
            base = quickstart.served_at(log_path)
            if base is not None or srv.poll() is not None:
                break
            time.sleep(0.5)
        assert base is not None, quickstart.log_tail(log_path)
        assert base.startswith('http://127.0.0.1:')
        assert int(base.rsplit(':', 1)[1]) > 0
        health = ServingClient(base, timeout=60).healthz()
        assert health['ok'] and health['shapes'] == ['b2xt8']
    finally:
        srv.terminate()
        try:
            srv.wait(timeout=60)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
