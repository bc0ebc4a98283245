"""Where a training step's time goes on the card.

    python3 -m fvt_tpu_torch.tools.profile_train [--steps 10] [--top 12]

Builds the full-width ``vggish+bert`` LFAN (random init from seed 0),
trains it at (16, 300) on seeded batches through ``Trainer``'s step, and
traces ``--steps`` warm steps with ``torch.profiler`` for each of the
fused path and the conv-by-conv path on cuDNN.  Prints per path the wall
time a step, the summed device kernel time a step, the device's idle
share, and the kernels that take most of the device time.  Needs a CUDA
card; float32 with TF32 off.
"""
from __future__ import annotations

import argparse
import copy
import subprocess
import sys
import time

import numpy as np
import torch

MODALITY = ('vggish', 'bert')
BATCH, WINDOW, SEED = 16, 300, 0


def make_batches(n: int) -> list:
    from fvt_tpu_torch.config import model_config as MC
    rng = np.random.default_rng(SEED + 3)
    return [{**{m: rng.standard_normal(
                (BATCH, WINDOW) + tuple(MC.FEATURE_DIMENSION[m]), np.float32)
                for m in MODALITY},
             'EXPR_continuous_label': rng.integers(0, 7, (BATCH, WINDOW))}
            for _ in range(n)]


def profile(trainer, batches: list, steps: int, top: int) -> None:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    def run(n):
        for i in range(n):
            trainer.train_step(batches[i % len(batches)],
                               trainer.step_generator(0, i))
        torch.cuda.synchronize()

    run(5)
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        run(steps)
    events = [e for e in prof.key_averages()
              if getattr(e, 'device_time_total', 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in events) / 1e3 / steps
    launches = sum(e.count for e in events) / steps
    print(f'  wall {wall_ms:.3f} ms a step (untraced), device kernels '
          f'{device_ms:.3f} ms a step in {launches:.0f} launches, idle '
          f'share {max(0.0, 1 - device_ms / wall_ms):.1%}')
    if not events:
        print('  the profiler recorded no device time')
        return
    events.sort(key=lambda e: -e.device_time_total)
    for e in events[:top]:
        ms = e.device_time_total / 1e3 / steps
        print(f'    {ms:8.4f} ms {ms / device_ms:6.1%} x{e.count / steps:5.1f}'
              f'  {e.key[:90]}')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--steps', type=int, default=10)
    ap.add_argument('--top', type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('profile_train: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fvt_tpu_torch.config.defaults import get_train_config
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.train.trainer import Trainer

    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip())
    device = torch.device('cuda', 0)
    model = LFAN(MODALITY, output_dim=7,
                 generator=torch.Generator().manual_seed(SEED))
    batches = make_batches(2)
    for name, fused in (('fused', True), ('conv-by-conv', False)):
        print(f'{name} step at ({BATCH}, {WINDOW}):')
        trainer = Trainer(copy.deepcopy(model), get_train_config(), device,
                          tcn_fused=fused)
        profile(trainer, batches, args.steps, args.top)
    return 0


if __name__ == '__main__':
    sys.exit(main())
