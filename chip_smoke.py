#!/usr/bin/env python3
"""Drives the PyTorch port's LFAN serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. build the CUDA kernels of ``fvt_tpu_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it: the TCN block at all 12 block shapes
   of the tri-modal LFAN at (8, 300), the fusion block at (8, 300,
   {128, 32, 128}); print errors and median times (CUDA events);
3. serve three streams of 250, 700 and 1000 frames through the unchanged
   ``fvt_tpu.streaming`` server core over a full-width tri-modal LFAN
   (``video+vggish+bert``, random init from seed 0); check every frame's
   logits against an offline stitch of the plain-version forward and the
   kernels' launch counts; time full (8, 300) dispatches.

Everything runs in float32 with TF32 off for matmuls and cuDNN.  The last
line of standard output is ``{"ok": true, "device": {...}}``; the line
before it lists the kernels.  Without a CUDA card the script exits with
code 1 and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WINDOW_BATCH, WINDOW, HOP = 8, 300, 200  # defaults.py:59-60,152
MODALITY = ('video', 'vggish', 'bert')
STREAM_LENGTHS = (250, 700, 1000)
CHUNK = 100
SEED = 0
RUNS = 20
# kernel vs plain version: both fp32, summed in another order
KERNEL_RTOL = KERNEL_ATOL = 1e-4
# served logits vs the offline stitch of the plain-version forward
SERVE_ATOL = 1e-3


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def median_ms(fn, runs: int = RUNS) -> float:
    """Median time of ``fn()`` on the card over ``runs`` calls, after
    three warm-up calls, with CUDA events around each call."""
    for _ in range(3):
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


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    err = (got - want).abs()
    bound = KERNEL_ATOL + KERNEL_RTOL * want.abs()
    max_abs = err.max().item()
    print(f'  {name}: max_abs_err={max_abs:.3e} '
          f'max_rel_err={max_abs / want.abs().max().item():.3e} '
          f'finite={bool(torch.isfinite(got).all())}')
    if not torch.isfinite(got).all() or (err > bound).any():
        fail(f'{name}: kernel disagrees with its plain version '
             f'(rtol={KERNEL_RTOL}, atol={KERNEL_ATOL})')
    return max_abs


def check_kernels(model, device) -> list:
    """Phase 2: each kernel against its plain version at the serving
    path's shapes, on inputs that flow through the model's own weights."""
    from fvt_tpu_torch.models.layers import fold_batchnorm
    from fvt_tpu_torch.ops import fusion as fusion_ops
    from fvt_tpu_torch.ops import tcn as tcn_ops

    g = torch.Generator(device=device).manual_seed(SEED)
    k = model.temporal[MODALITY[0]].kernel_size
    tcn_err, tcn_ms, tcn_plain_ms = 0.0, 0.0, 0.0
    feats = {}
    with torch.inference_mode():
        for m in MODALITY:
            net = model.temporal[m]
            cin = net.network[0].conv1.weight_v.shape[1]
            x = torch.randn(WINDOW_BATCH, WINDOW, cin, device=device,
                            generator=g)
            for i, blk in enumerate(net.network):
                w = blk.kernel_weights()
                args = (x, w['w1'], w['b1'], w['w2'], w['b2'], w['wd'],
                        w['bd'])
                kw = dict(kernel_size=k, dilation=2 ** i)
                want = tcn_ops.fused_temporal_block_ref(*args, **kw)
                got = tcn_ops.fused_temporal_block(*args, **kw)
                name = (f'tcn_block {m}.{i} ({WINDOW_BATCH},{WINDOW},'
                        f'{x.shape[-1]})->{want.shape[-1]} d={2 ** i}')
                tcn_err = max(tcn_err, compare(name, got, want))
                ms = median_ms(lambda: tcn_ops.fused_temporal_block(
                    *args, **kw))
                plain = median_ms(lambda: tcn_ops.fused_temporal_block_ref(
                    *args, **kw))
                print(f'    kernel {ms:.4f} ms, plain {plain:.4f} ms')
                tcn_ms += ms
                tcn_plain_ms += plain
                x = want.contiguous()
            scale, shift = fold_batchnorm(model.bn[m])
            feats[m] = x * scale + shift

        # edge cases the serving shapes do not reach: a row shorter than
        # the halo, a tile-multiple length, widths off the model's
        for (b, t, cin, cout, d, ds) in [(2, 7, 64, 64, 8, False),
                                         (3, 32, 48, 128, 4, True),
                                         (1, 1, 20, 8, 1, True),
                                         (2, 90, 256, 256, 16, False)]:
            x = torch.randn(b, t, cin, device=device, generator=g)
            w1 = torch.randn(k, cin, cout, device=device, generator=g) * 0.1
            w2 = torch.randn(k, cout, cout, device=device, generator=g) * 0.1
            b1, b2, bd = (torch.randn(cout, device=device, generator=g)
                          for _ in range(3))
            wd = torch.randn(cin, cout, device=device, generator=g) * 0.1
            args = (x, w1, b1, w2, b2, wd if ds else None,
                    bd if ds else None)
            kw = dict(kernel_size=k, dilation=d)
            compare(f'tcn_block edge ({b},{t},{cin})->{cout} d={d} ds={ds}',
                    tcn_ops.fused_temporal_block(*args, **kw),
                    tcn_ops.fused_temporal_block_ref(*args, **kw))

        fusion = model.fusion
        attn = fusion.layers.self_attn
        lins = [attn.qkv_proj[m] for m in MODALITY]
        args = ([feats[m] for m in MODALITY],
                [lin.weight.t().contiguous() for lin in lins],
                [lin.bias for lin in lins],
                attn.o_proj.weight.t().contiguous(), attn.o_proj.bias,
                fusion.layers.norm1.weight, fusion.layers.norm1.bias)
        kw = dict(modal_dim=fusion.modal_dim, num_heads=fusion.num_heads)
        fusion_err = compare(
            f'fusion ({WINDOW_BATCH},{WINDOW},'
            f'{[feats[m].shape[-1] for m in MODALITY]})',
            fusion_ops.fused_multimodal_fusion(*args, **kw),
            fusion_ops.fused_multimodal_fusion_ref(*args, **kw))
        fusion_ms = median_ms(
            lambda: fusion_ops.fused_multimodal_fusion(*args, **kw))
        fusion_plain_ms = median_ms(
            lambda: fusion_ops.fused_multimodal_fusion_ref(*args, **kw))
        print(f'    kernel {fusion_ms:.4f} ms, plain '
              f'{fusion_plain_ms:.4f} ms')
    print(f'  tcn_block total over the 12 blocks: kernel {tcn_ms:.4f} ms, '
          f'plain {tcn_plain_ms:.4f} ms')
    return [
        {'name': 'tcn_block', 'route': 'cuda',
         'source': 'fvt_tpu_torch/csrc/tcn_block.cu',
         'replaces': 'fvt_tpu/ops/tcn_pallas.py:35',
         'max_abs_err': tcn_err, 'ms': tcn_ms, 'plain_ms': tcn_plain_ms},
        {'name': 'fusion', 'route': 'cuda',
         'source': 'fvt_tpu_torch/csrc/fusion.cu',
         'replaces': 'fvt_tpu/ops/fusion_pallas.py:25',
         'max_abs_err': fusion_err, 'ms': fusion_ms,
         'plain_ms': fusion_plain_ms},
    ]


def make_streams() -> dict:
    rng = np.random.default_rng(SEED)
    return {n: {'video': rng.integers(0, 256, (n, 40, 40, 3), np.uint8),
                'vggish': rng.standard_normal((n, 128), np.float32),
                'bert': rng.standard_normal((n, 768), np.float32)}
            for n in STREAM_LENGTHS}


def serve_streams(server, streams: dict) -> tuple:
    """Feeds every stream through one StreamingRegistry in CHUNK-frame
    pieces, round-robin, then closes them.  Returns ({length: (L, C)
    logits}, dispatches)."""
    from fvt_tpu.streaming import StreamingRegistry

    registry = StreamingRegistry(server, dynamic_batch=True)
    sids = {n: registry.open() for n in streams}
    pieces = {n: [] for n in streams}
    for c0 in range(0, max(streams), CHUNK):
        for n, frames in streams.items():
            if c0 < n:
                chunk = {k: v[c0:c0 + CHUNK] for k, v in frames.items()}
                pieces[n].append(registry.feed(sids[n], chunk))
    for n in streams:
        pieces[n].append(registry.close(sids[n]))
    out = {}
    for n, parts in pieces.items():
        nxt = 0
        for start, logits in parts:
            if len(logits) and start != nxt:
                fail(f'stream {n}: frames from {start} arrived, '
                     f'expected {nxt}')
            nxt += len(logits)
        out[n] = np.concatenate([p[1] for p in parts])
    return out, registry.batcher.dispatches


def offline_reference(model, streams: dict, device) -> dict:
    """The offline path: window each whole stream, run the plain-version
    forward, stitch (or take the first L rows of one pad-by-repeat window
    for a stream shorter than the window)."""
    from fvt_tpu.data import windowing as W
    from fvt_tpu_torch.serve import lfan_serving_forward

    out = {}
    for n, frames in streams.items():
        if n < WINDOW:
            idx = W.pad_short_window_indices(n, WINDOW)[None]
        else:
            idx = W.window_index_matrix(n, WINDOW, HOP)
        batch = {k: torch.from_numpy(v[idx]).to(device)
                 for k, v in frames.items()}
        logits = lfan_serving_forward(model, batch, reference=True)
        logits = logits.cpu().numpy()
        out[n] = (logits[0, :n] if n < WINDOW
                  else W.stitch_windows_np(logits, idx, n))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on a GPU',
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')

    from fvt_tpu_torch.data.transforms import eval_video_transform
    from fvt_tpu_torch.kernels import build
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.ops.fusion import fused_multimodal_fusion
    from fvt_tpu_torch.ops.tcn import fused_temporal_block
    from fvt_tpu_torch.serve import ServingModel

    device = torch.device('cuda', 0)
    print('phase 1: build')
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f'  {path.relative_to(build.BUILD_DIR.parent)} in '
          f'{time.perf_counter() - t0:.1f} s')
    log = path.with_suffix('.log').read_text().splitlines()
    for line in log:
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            print('  ' + line.strip())

    model = LFAN(MODALITY, output_dim=7,
                 generator=torch.Generator().manual_seed(SEED)).to(device)

    print('phase 2: kernels vs plain versions '
          f'(rtol={KERNEL_RTOL}, atol={KERNEL_ATOL}; fp32, other '
          f'summation order)')
    kernels = check_kernels(model, device)

    print('phase 3: serving through fvt_tpu.streaming')
    server = ServingModel(model, WINDOW_BATCH, WINDOW, HOP, device)
    streams = make_streams()
    fused_temporal_block.launches = 0
    fused_multimodal_fusion.launches = 0
    served, dispatches = serve_streams(server, streams)
    launches = (fused_temporal_block.launches,
                fused_multimodal_fusion.launches)
    print(f'  {dispatches} dispatches, tcn_block launches {launches[0]}, '
          f'fusion launches {launches[1]}')
    if dispatches < 1 or launches != (12 * dispatches, dispatches):
        fail(f'expected 12 tcn_block and 1 fusion launch per dispatch, got '
             f'{launches} over {dispatches} dispatches')
    kernels[0]['launches'], kernels[1]['launches'] = launches

    want = offline_reference(model, streams, device)
    for n in STREAM_LENGTHS:
        got = served[n]
        if got.shape != (n, model.output_dim) or not np.isfinite(got).all():
            fail(f'stream {n}: got {got.shape} logits, finite='
                 f'{np.isfinite(got).all()}')
        err = float(np.abs(got - want[n]).max())
        print(f'  stream {n}: {got.shape} logits, max |served - offline '
              f'plain| = {err:.3e} (atol {SERVE_ATOL})')
        if err > SERVE_ATOL:
            fail(f'stream {n}: served logits differ from the offline '
                 f'reference by {err}')

    rng = np.random.default_rng(SEED + 1)
    inputs = {k: (rng.integers(0, 256, s['shape'], np.uint8)
                  if s['dtype'] == 'uint8'
                  else rng.standard_normal(s['shape'], np.float32))
              for k, s in server.specs.items()}
    for _ in range(3):
        server.call(inputs)
    times = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        out = server.call(inputs)  # returns numpy: forced to the host
        times.append(time.perf_counter() - t0)
    if not np.isfinite(out).all():
        fail('timed dispatch gave non-finite logits')
    frames = WINDOW_BATCH * WINDOW
    med = statistics.median(times)
    print(f'  full ({WINDOW_BATCH},{WINDOW}) dispatch, {RUNS} warm runs: '
          f'median {med * 1e3:.2f} ms, min {min(times) * 1e3:.2f} ms, '
          f'max {max(times) * 1e3:.2f} ms -> {frames / med:.1f} frames/s')
    video = torch.from_numpy(inputs['video']).to(device)
    crops = eval_video_transform(video).reshape(frames, 40, 40, 3)
    with torch.inference_mode():
        backbone_ms = median_ms(lambda: model.spatial.visual(crops))
    print(f'  ArcFace IR-50 alone on {frames} frames: {backbone_ms:.2f} ms')

    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
