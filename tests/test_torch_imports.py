"""The port needs neither JAX, flax nor PyYAML, and chip_smoke.py refuses
to run without a CUDA card."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_JAX = textwrap.dedent('''
    import importlib.abc
    import sys

    BLOCKED = ('jax', 'jaxlib', 'flax', 'yaml')

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in BLOCKED:
                raise ModuleNotFoundError(f'{name} is blocked', name=name)
            return None

    sys.meta_path.insert(0, Block())

    import numpy as np
    import torch

    import fvt_tpu_torch
    import fvt_tpu_torch.kernels.build
    from fvt_tpu.streaming import StreamingSession
    from fvt_tpu_torch.models.from_jax import lfan_state_from_flax
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.serve import ServingModel

    tcn = {'vggish': [8, 8, 4, 4], 'bert': [8, 8, 4, 4]}
    model = LFAN(('vggish', 'bert'), 7, tcn_channel=tcn,
                 encoder_dim={'vggish': 4, 'bert': 4},
                 generator=torch.Generator().manual_seed(0))
    sess = StreamingSession(ServingModel(model, 2, 6, 4, 'cpu'))
    rng = np.random.default_rng(0)
    frames = {'vggish': rng.normal(size=(9, 128)).astype(np.float32),
              'bert': rng.normal(size=(9, 768)).astype(np.float32)}
    first = sess.feed(frames)[1]
    rest = sess.close()[1]
    out = np.concatenate([first, rest])
    assert out.shape == (9, 7) and np.isfinite(out).all(), out.shape
    leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not leaked, leaked
    print('served', out.shape)
''')


def _env():
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (REPO, env.get('PYTHONPATH')) if p)
    return env


def test_port_imports_and_serves_without_jax_flax_yaml():
    proc = subprocess.run([sys.executable, '-c', NO_JAX], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'served (9, 7)' in proc.stdout


def test_chip_smoke_refuses_a_machine_without_cuda():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip('needs a machine without a CUDA card')
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert 'no CUDA device' in proc.stderr
