"""The serving dispatch's two small kernels on the card, as a package
checkout has them: the eval TCN block (B1) at its 12 blocks and the
fusion (B2) at three modalities.

    python3 -m fvt_tpu_torch.tools.time_serving_kernels [--runs 40]
    PYTHONPATH=<checkout> python3 fvt_tpu_torch/tools/time_serving_kernels.py

It times the ``fvt_tpu_torch`` that Python imports: the second form
times another checkout's package (its kernels built in its own
``build/``), so two versions compare in one call by running it on each
in turns (one, the other, the other, the one).  At the 12 block shapes
of a tri-modal LFAN's serving dispatch (8 windows of 300 frames; video 512,
vggish 128 and bert 768 channels in; the model's random init from seed
0) and at the fusion of its three TCN outputs (128, 32, 128 channels,
modal_dim 32, 2 heads): each call's median time with its wrapper (CUDA
events around the call, ``--runs`` calls after 5 warm ones) and the
device time of the kernels alone (``torch.profiler`` over 20 passes).
The fusion is timed as a dispatch calls it, through the model's
``fusion`` module in eval mode (with the weight copies a checkout's
module makes a call), and its device time is that of the fusion kernel,
found by name: ``fusion_kernel`` (the CUDA-core kernel, which
checkouts before the split-TF32 one launch) or ``fusion_tf32x3_kernel``.
Prints one JSON line.  Needs a CUDA card; float32 with TF32 off.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess

import torch

import fvt_tpu_torch
from fvt_tpu_torch.kernels import build
from fvt_tpu_torch.models.models import LFAN
from fvt_tpu_torch.ops import tcn as tcn_ops

WINDOW_BATCH, WINDOW = 8, 300
MODALITY = ('video', 'vggish', 'bert')
# tools/timing.py from beside this file: the package imported may be an
# older checkout's, without it
_spec = importlib.util.spec_from_file_location(
    'fvt_timing', os.path.join(os.path.dirname(__file__), 'timing.py'))
timing = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(timing)


def median_ms(fn, runs: int) -> float:
    for _ in range(5):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--runs', type=int, default=40)
    runs = parser.parse_args().runs
    if not torch.cuda.is_available():
        raise SystemExit('time_serving_kernels: no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device('cuda', 0)
    build.library()
    g = torch.Generator(device=device).manual_seed(0)
    model = LFAN(MODALITY, output_dim=7,
                 generator=torch.Generator().manual_seed(0)).to(device)
    calls, block_ms, feats = [], [], []
    with torch.inference_mode():
        for m in MODALITY:
            net = model.temporal[m]
            cin = net.network[0].conv1.weight_v.shape[1]
            x = torch.randn(WINDOW_BATCH, WINDOW, cin, device=device,
                            generator=g)
            for i, blk in enumerate(net.network):
                w = blk.eval_weights()
                args = (x, w['w1'], w['b1'], w['w2'], w['b2'], w['wd'],
                        w['bd'])
                kw = dict(kernel_size=net.kernel_size, dilation=2 ** i,
                          packed=w['packed'])

                def call(args=args, kw=kw):
                    return tcn_ops.fused_temporal_block(*args, **kw)
                calls.append(call)
                block_ms.append(median_ms(call, runs))
                x = call()
            feats.append(x)
        feats = dict(zip(MODALITY, feats))

        def fusion():
            return model.fusion(feats)
        fusion_ms = median_ms(fusion, runs)
        tcn_device = timing.device_ms(lambda: [c() for c in calls],
                                      ('causal_conv',))
        fusion_device = timing.device_ms(fusion, ('fusion_kernel',
                                                  'fusion_tf32x3_kernel'))
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({'package': os.path.dirname(fvt_tpu_torch.__file__),
                      'card': card,
                      'tcn_12_blocks_ms': sum(block_ms),
                      'tcn_block_ms': block_ms,
                      'tcn_12_blocks_device_ms': tcn_device,
                      'fusion_m3_ms': fusion_ms,
                      'fusion_m3_device_ms': fusion_device}))


if __name__ == '__main__':
    main()
