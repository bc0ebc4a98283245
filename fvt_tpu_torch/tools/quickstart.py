"""One-command acceptance drive of the whole port (``tools/quickstart.py``
of ``fvt_tpu``, through the port's CLIs).

Runs the user's journey on a throwaway synthetic store and asserts every
artifact the contract promises:

  1. build a synthetic MELD store (``tools/synth_store.make_meld_store``)
  2. fsck it (``python -m fvt_tpu_torch.tools.validate_store --deep``,
     must be clean)
  3. train 2 epochs through ``python -m fvt_tpu_torch.main``, checking the
     artifact contract: passed.txt, config.yml, log.json,
     test-*-perf.{txt,pkl}, best-models/<item>/model.msgpack
  4. the EVALUATION retarget of the trained run onto a synthetic challenge
     store (``python -m fvt_tpu_torch.inference_challenge``) ->
     prediction.pkl
  5. export the frozen serving artifact (``tools/export_serving.py``)
  6. serve it over HTTP (``tools/serve_http.py --port 0``, which binds a
     port the system picks and names it in its log, ``serve_http.log``
     in the workdir): /healthz, one /logits
     call, and one streamed session through ``fvt_tpu_torch.client``,
     whose logits must equal the offline stitch of /logits calls on the
     same frames
  7. aggregate the run with ``tools/summarize_runs.py`` (one table row a
     selection criterion)

Every stage runs on the card unless ``--device cpu`` is given, which each
CLI gets too.  Exit 0 = the port works end to end.  Prints each stage's
wall, then ``quickstart OK — all 7 stages passed: ...`` last::

    python -m fvt_tpu_torch.tools.quickstart [--workdir DIR] [--keep] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
from os.path import isfile, join
from typing import Dict, Optional

import numpy as np


REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WINDOW, HOP, WINDOW_BATCH = 8, 4, 4
# streamed against offline logits: the same kernels on the same windows
STREAM_ATOL = 1e-5
SERVING_LINE = re.compile(r'^serving .* on (http://[^:\s]+:\d+) ', re.M)


def run_cli(module: str, args: list, stage: str, timeout: float = 900):
    """``python -m <module> <args>`` from the repo root; raises with its
    output's tail if it fails."""
    r = subprocess.run([sys.executable, '-m', module, *args], cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        print(r.stdout[-3000:])
        print(r.stderr[-3000:])
        raise SystemExit(f'quickstart FAILED at {stage}: {module} exit '
                         f'{r.returncode}')
    return r


def served_at(log_path: str) -> Optional[str]:
    """``http://host:port`` from serve_http's ``serving ... on
    http://host:port`` line in its log, None before the line is there."""
    with open(log_path, errors='replace') as f:
        m = SERVING_LINE.search(f.read())
    return m.group(1) if m else None


def log_tail(log_path: str, chars: int = 3000) -> str:
    with open(log_path, errors='replace') as f:
        return f.read()[-chars:]


def offline_stitch(client, clip: Dict[str, np.ndarray]) -> np.ndarray:
    """The logits of a clip as a stream gives them, from /logits calls: its
    windows (WINDOW, HOP) in batches of WINDOW_BATCH, the last repeat-
    padded, stitched."""
    from fvt_tpu_torch.data import windowing as W
    n = len(next(iter(clip.values())))
    idx = W.window_index_matrix(n, WINDOW, HOP)
    outs = []
    for s in range(0, len(idx), WINDOW_BATCH):
        rows = list(idx[s:s + WINDOW_BATCH])
        rows += [rows[-1]] * (WINDOW_BATCH - len(rows))
        out = client.logits({k: v[np.stack(rows)] for k, v in clip.items()})
        outs.append(out[:len(idx) - s])
    return W.stitch_windows_np(np.concatenate(outs), idx, n)


def main(workdir: Optional[str] = None, keep: bool = False,
         device: Optional[str] = None) -> Dict[str, float]:
    """The seven stages; returns each stage's wall in seconds."""
    from fvt_tpu_torch.tools.synth_store import (make_cexpr_store,
                                                 make_meld_store)
    workdir = workdir or join(tempfile.gettempdir(), 'fvt_torch_quickstart')
    dev = ['--device', device] if device else []
    if os.path.isdir(workdir):
        shutil.rmtree(workdir)
    os.makedirs(workdir)
    walls: Dict[str, float] = {}

    def stage(name):
        print(f'\n== quickstart: {name} ==', flush=True)
        walls[name] = time.perf_counter()
        return name

    def done(name):
        walls[name] = time.perf_counter() - walls[name]

    # 1. synthetic store -------------------------------------------------
    s = stage('build synthetic store')
    store = make_meld_store(join(workdir, 'store'), n_train=12, n_val=4,
                            n_test=4, min_len=6, max_len=20)
    done(s)

    # 2. fsck ------------------------------------------------------------
    s = stage('fsck (validate_store --deep)')
    run_cli('fvt_tpu_torch.tools.validate_store',
            ['--dataset_path', store['dataset_path'], '--dataset_name',
             'MELD', '--folds_dir', store['folds_dir'], '--deep'], s)
    done(s)

    # 3. train 2 epochs through the CLI ----------------------------------
    s = stage('train (fvt_tpu_torch.main, 2 epochs)')
    outd = join(workdir, 'run')
    run_cli('fvt_tpu_torch.main',
            ['--dataset_name', 'MELD',
             '--dataset_path', store['dataset_path'],
             '--folds_dir', store['folds_dir'],
             '--modality', 'vggish+bert+EXPR_continuous_label',
             '--model_name', 'LFAN', '--num_epochs', '2',
             '--train_batch_size', '4', '--num_workers', '1',
             '--window_length', str(WINDOW), '--hop_length', str(HOP),
             '--eval_bucket_quantum', str(WINDOW),
             '--eval_window_batch', str(WINDOW_BATCH), '--outd', outd,
             *dev], s)
    for f in ('passed.txt', 'config.yml', 'log.json',
              'test-FRAMES_VOTE-perf.pkl', 'test-FRAMES_VOTE-perf.txt',
              join('best-models', 'FRAMES_VOTE', 'model.msgpack')):
        assert isfile(join(outd, f)), f'missing run artifact: {f}'
    done(s)

    # 4. EVALUATION retarget onto a challenge store ----------------------
    s = stage('challenge inference (EVALUATION retarget)')
    ch = make_cexpr_store(join(workdir, 'challenge'),
                          ds='C-EXPR-DB-CHALLENGE', n_train=3, min_len=6,
                          max_len=12, video_hw=64)
    run_cli('fvt_tpu_torch.inference_challenge',
            ['--mode', 'EVALUATION', '--fd_exp', outd,
             '--case_best_model', 'FRAMES_VOTE',
             '--target_ds_name', 'C-EXPR-DB-CHALLENGE',
             '--dataset_path', ch['dataset_path'],
             '--folds_dir', ch['folds_dir'],
             '--eval_window_batch', str(WINDOW_BATCH), *dev], s)
    pred = join(outd, 'eval-C-EXPR-DB-CHALLENGE',
                'pred-C-EXPR-DB-CHALLENGE', 'prediction.pkl')
    assert isfile(pred), f'missing {pred}'
    done(s)

    # 5. frozen serving artifact -----------------------------------------
    s = stage('export serving artifact (.fvtserve)')
    art = join(workdir, 'serving.fvtserve')
    run_cli('fvt_tpu_torch.tools.export_serving',
            ['--fd_exp', outd, '--out', art,
             '--window_batch', str(WINDOW_BATCH), *dev], s)
    assert isfile(art) and os.path.getsize(art) > 1000
    done(s)

    # 6. HTTP serving: one logits call + one streamed session ------------
    s = stage('serve over HTTP (logits + streamed session)')
    # the server binds a port the system picks and names it in its log
    log_path = join(workdir, 'serve_http.log')
    with open(log_path, 'w') as log:
        srv = subprocess.Popen(
            [sys.executable, '-m', 'fvt_tpu_torch.tools.serve_http',
             '--artifact', art, '--port', '0', *dev], cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT)
    try:
        base = None
        for _ in range(240):
            if base is None:
                base = served_at(log_path)
            if base is not None:
                try:
                    urllib.request.urlopen(base + '/healthz', timeout=2)
                    break
                except OSError:
                    pass
            if srv.poll() is not None:
                raise SystemExit(f'serve_http died during startup (exit '
                                 f'{srv.returncode}); its log ends:\n'
                                 f'{log_tail(log_path)}')
            time.sleep(0.5)
        else:
            raise SystemExit(f'serve_http never became healthy; its log '
                             f'ends:\n{log_tail(log_path)}')

        from fvt_tpu_torch.client import ServingClient
        c = ServingClient(base)
        assert c.healthz()['ok']
        rng = np.random.default_rng(0)
        batch = {'vggish': rng.normal(size=(WINDOW_BATCH, WINDOW, 128)
                                      ).astype(np.float32),
                 'bert': rng.normal(size=(WINDOW_BATCH, WINDOW, 768)
                                    ).astype(np.float32)}
        logits = c.logits(batch)
        assert logits.shape == (WINDOW_BATCH, WINDOW, 7), logits.shape

        clip = {'vggish': rng.normal(size=(13, 128)).astype(np.float32),
                'bert': rng.normal(size=(13, 768)).astype(np.float32)}
        streamed = c.stream(clip, chunk=5)
        assert streamed.shape == (13, 7), streamed.shape
        assert np.isfinite(streamed).all()
        want = offline_stitch(c, clip)
        err = float(np.abs(streamed - want).max())
        print(f'streamed vs /logits on the same frames: max |diff| = '
              f'{err:.3e}')
        assert err <= STREAM_ATOL, (err, STREAM_ATOL)
    finally:
        srv.terminate()
        try:
            srv.wait(timeout=30)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
    done(s)

    # 7. cross-run summary -----------------------------------------------
    s = stage('summarize_runs over the completed run')
    sj = join(workdir, 'summary.json')
    r = run_cli('fvt_tpu_torch.tools.summarize_runs',
                ['--roots', workdir, '--json', sj], s)
    with open(sj) as f:
        summary = json.load(f)
    assert len(summary['runs']) >= 3, summary  # one row per criterion
    print(r.stdout[-1500:])
    done(s)

    for name, wall in walls.items():
        print(f'  {name}: {wall:.1f} s')
    print(f'\nquickstart OK — all {len(walls)} stages passed: '
          f'{", ".join(walls)}')
    if not keep:
        shutil.rmtree(workdir)
    return walls


if __name__ == '__main__':
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workdir', default=None,
                   help='default: fvt_torch_quickstart in the temp dir')
    p.add_argument('--keep', action='store_true',
                   help='keep the workdir for inspection')
    p.add_argument('--device', default=None,
                   help="every stage's device: the card by default")
    a = p.parse_args()
    main(a.workdir, a.keep, a.device)
