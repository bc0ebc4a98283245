"""``python -m fvt_tpu_torch.tools.quickstart --device cpu``: the seven
stages through the port's CLIs (a synthetic MELD store, ``validate_store
--deep``, 2 epochs of ``fvt_tpu_torch.main``, challenge inference, the
``.fvtserve`` export, ``serve_http`` with /healthz, /logits and a streamed
session equal to the offline stitch of /logits calls, ``summarize_runs``)
reach the last line, ``quickstart OK — all 7 stages passed``.  The
subprocesses run one intra-op thread each (OMP_NUM_THREADS=1): the
suite's workers share the cores.
"""
import subprocess
import sys
from os.path import dirname, abspath

REPO = dirname(dirname(abspath(__file__)))


def test_quickstart_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    r = subprocess.run([sys.executable, '-m', 'fvt_tpu_torch.tools.quickstart',
                        '--device', 'cpu', '--workdir', str(tmp_path / 'qs')],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith('quickstart OK — all 7 stages passed: '), last
    assert 'streamed vs /logits on the same frames' in r.stdout
    assert not (tmp_path / 'qs').exists()  # removed without --keep
