"""Where a training step's time goes on the card.

    python3 -m fvt_tpu_torch.tools.profile_train [--steps 10] [--top 12]
    python3 -m fvt_tpu_torch.tools.profile_train --blocks [--steps 10]
    python3 -m fvt_tpu_torch.tools.profile_train --diag [--steps 10]

Builds the full-width ``vggish+bert`` LFAN (random init from seed 0),
trains it at (16, 300) on seeded batches through ``Trainer``'s step, and
traces ``--steps`` warm steps with ``torch.profiler`` for each of the
fused path and the conv-by-conv path on cuDNN.  Prints per path the wall
time a step, the summed device kernel time a step, the device's idle
share, and the kernels that take most of the device time.

``--blocks`` traces the train-mode TCN block alone instead, at the 8
blocks of that LFAN (random inputs and weights at the init scale, dropout
0.1, x without a gradient at each modality's first block as on the
training path): for the split-TF32 kernels (``fused_temporal_block_
train``) and the CUDA-core ones (``fused_temporal_block_train_simt``), a
pass of the 8 forwards and, apart, of the 8 backwards (on retained
graphs), each with its wall time (host clock) and device time by kernel
(``torch.profiler``).  ``--diag`` times the weight-gradient launches
of the split-TF32 backward at those 8 blocks once a diagnostic build of
``csrc/tcn_block_train_tf32x3.cu`` (the kernel as it is, no copies, no
products, no split; its header note).  Needs a CUDA card; float32 with
TF32 off.
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


def traced(fn, passes: int) -> tuple:
    """(wall ms, device ms, {kernel: (device ms, launches)}) a pass of
    ``fn``, after 3 warm passes: the wall untraced, the device traced."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / passes
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: (e.device_time_total / 1e3 / passes, e.count / passes)
               for e in prof.key_averages()
               if getattr(e, 'device_time_total', 0) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA}
    return wall, sum(ms for ms, _ in kernels.values()), kernels


def blocks(passes: int) -> None:
    """``--blocks``: the train block's two routes at the 8 blocks."""
    from fvt_tpu_torch.config import model_config as MC
    from fvt_tpu_torch.ops import tcn as tcn_ops

    g = torch.Generator(device='cuda').manual_seed(SEED)
    k, p = 5, 0.1

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device='cuda', generator=g) * scale

    cases = []
    for m in MODALITY:
        cin = MC.EMBEDDING_DIM[m]
        for i, cout in enumerate(MC.TCN_CHANNELS[m]):
            keep = torch.full((BATCH, WINDOW, cout), 1 - p, device='cuda')
            masks = [torch.bernoulli(keep, generator=g) / (1 - p)
                     for _ in range(2)]
            leaves = [randn(k, cin, cout, scale=(k * cin) ** -0.5),
                      randn(cout, scale=0.1),
                      randn(k, cout, cout, scale=(k * cout) ** -0.5),
                      randn(cout, scale=0.1), randn(BATCH, WINDOW, cout)]
            x = randn(BATCH, WINDOW, cin).requires_grad_(i > 0)
            for v in leaves:
                v.requires_grad_(True)
            cases.append((x, leaves, masks, 2 ** i,
                          randn(BATCH, WINDOW, cout)))
            cin = cout
    for name, fn in (('split-TF32', tcn_ops.fused_temporal_block_train),
                     ('SIMT', tcn_ops.fused_temporal_block_train_simt)):
        def forward(fn=fn):
            return [fn(x, w1, b1, w2, b2, m1, m2, res, kernel_size=k,
                       dilation=d)
                    for x, (w1, b1, w2, b2, res), (m1, m2), d, _ in cases]

        with torch.no_grad():
            fwd = traced(forward, passes)
        outs = forward()

        def backward():
            for out, (x, leaves, _, _, cot) in zip(outs, cases):
                inputs = leaves + ([x] if x.requires_grad else [])
                torch.autograd.grad(out, inputs, cot, retain_graph=True)

        bwd = traced(backward, passes)
        for what, (wall, dev, kernels) in (('forward', fwd),
                                           ('backward', bwd)):
            print(f'{name} {what}, 8 blocks: wall {wall:.4f} ms, device '
                  f'{dev:.4f} ms in {sum(n for _, n in kernels.values()):g}'
                  f' launches')
            for key, (ms, n) in sorted(kernels.items(),
                                       key=lambda kv: -kv[1][0]):
                print(f'    {ms:8.4f} ms x{n:4g}  {key[:100]}')


def diag(passes: int) -> None:
    """``--diag``: device ms of the weight-gradient launches (dw2 and dw1,
    with their shares' sums) at the 8 blocks, per diagnostic build of
    ``csrc/tcn_block_train_tf32x3.cu`` (its header note)."""
    from fvt_tpu_torch.config import model_config as MC
    from fvt_tpu_torch.ops import tcn as tcn_ops
    from fvt_tpu_torch.tools.profile_conv_bf16 import build_variants

    fns = build_variants('tcn_block_train_tf32x3.cu',
                         'fvt_tcn_block_train_tf32x3_backward', 24, 9, {
                             'kernel': (),
                             'products_only': ('-DFVT_DIAG_PRODUCTS_ONLY',),
                             'copies_only': ('-DFVT_DIAG_COPIES_ONLY',),
                             'no_split': ('-DFVT_DIAG_NO_SPLIT',)})
    g = torch.Generator(device='cuda').manual_seed(SEED)
    k = 5
    calls = []
    for m in MODALITY:
        cin = MC.EMBEDDING_DIM[m]
        for i, cout in enumerate(MC.TCN_CHANNELS[m]):
            def randn(*shape):
                return torch.randn(*shape, device='cuda', generator=g)

            x, w1, w2 = randn(BATCH, WINDOW, cin), randn(k, cin, cout), \
                randn(k, cout, cout)
            m1, m2, res, cot = (randn(BATCH, WINDOW, cout) for _ in range(4))
            saved = randn(3, BATCH, WINDOW, cout)
            shares = tcn_ops.train_shares(x, cout, k)
            scratch = torch.empty(tcn_ops.train_scratch(
                BATCH, WINDOW, cin, cout, k, 2 ** i, backward=True,
                shares=shares)[1], device='cuda')
            grads = (None, torch.empty_like(w1), randn(cout),
                     torch.empty_like(w2), randn(cout), torch.empty_like(m1))
            calls.append(((x, w1, w2, m1, m2, res), saved, cot, scratch,
                          grads, dict(kernel_size=k, dilation=2 ** i,
                                      shares=shares)))
            cin = cout
    for name, fn in fns.items():
        def run(fn=fn):
            for *args, kw in calls:
                tcn_ops.launch_train_tf32x3_backward(
                    *args, **kw, stages=tcn_ops.DW1 | tcn_ops.DW2,
                    entry=fn)

        _, dev, kernels = traced(run, passes)
        wgrad = sum(ms for key, (ms, _) in kernels.items()
                    if 'wgrad' in key)
        print(f'{name}: device {dev:.4f} ms a pass of the 8 blocks\' dw2 '
              f'and dw1, wgrad_kernel {wgrad:.4f} ms', flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--steps', type=int, default=10)
    ap.add_argument('--top', type=int, default=12)
    ap.add_argument('--blocks', action='store_true')
    ap.add_argument('--diag', action='store_true')
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
    if args.blocks or args.diag:
        (blocks if args.blocks else diag)(args.steps)
        return 0
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
