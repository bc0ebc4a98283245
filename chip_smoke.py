#!/usr/bin/env python3
"""Drives the PyTorch port's LFAN serving and training paths once on one
CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. build the CUDA kernels of ``fvt_tpu_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it: the eval TCN block at all 12 block
   shapes of the tri-modal LFAN at (8, 300), the fusion block at (8, 300,
   {128, 32, 128}), and the train-mode TCN block (forward output and the
   backward's six results, against autograd of the plain version) at the
   8 block shapes of the ``vggish+bert`` LFAN at (16, 300) with dropout
   masks at p=0.1, plus edge shapes; print errors and median times (CUDA
   events);
3. serve three streams of 250, 700 and 1000 frames through the
   ``fvt_tpu_torch.streaming`` server core over a full-width tri-modal
   LFAN (``video+vggish+bert``, random init from seed 0); check every
   frame's logits against an offline stitch of the plain-version forward
   and the kernels' launch counts; time full (8, 300) dispatches;
4. train a full-width ``vggish+bert`` LFAN for 10 steps at (16, 300)
   through ``Trainer`` with the fused train kernels; check the losses and
   final parameters against the same steps on the plain versions, that a
   step repeats bit for bit, and the launch counts (8 forward and 8
   backward launches a step, none of the eval-only fusion kernel); time
   steps of the fused path and of the conv-by-conv path on cuDNN.

Everything runs in float32 with TF32 off for matmuls and cuDNN.  The last
line of standard output is ``{"ok": true, "device": {...}}``; the line
before it lists the kernels.  Without a CUDA card the script exits with
code 1 and prints no result.
"""
from __future__ import annotations

import copy
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
# weight and bias gradients are sums over all B*T rows in another order
# than the plain version's: max|got - want| <= WGRAD_TOL * max|want|
WGRAD_TOL = 1e-4
# the training path: feature-only LFAN, defaults.py:65
TRAIN_MODALITY = ('vggish', 'bert')
TRAIN_BATCH = 16
TRAIN_STEPS = 10
TCN_DROPOUT = 0.1
# fused against plain training: per-step losses, then final parameters
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL = 2e-4, 1e-5
# published fp32 peaks of one H100 SXM, for the kernels' bounds
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
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


def compare_sum(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A gradient summed over all rows: error against the tensor's
    largest value."""
    torch.cuda.synchronize()
    max_abs = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f'  {name}: max_abs_err={max_abs:.3e} of max|want|={scale:.3e}')
    if not torch.isfinite(got).all() or max_abs > WGRAD_TOL * scale:
        fail(f'{name}: kernel disagrees with its plain version '
             f'(max|got - want| <= {WGRAD_TOL} * max|want|)')
    return max_abs


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: operations over the fp32 peak
    against bytes over the memory rate, whichever is larger."""
    ops_ms, bytes_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {'bound_ms': max(ops_ms, bytes_ms),
            'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes'}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def away_from_kink(x, w1, b1, w2, b2, m1, m2, res, dilation: int,
                   margin: float = 1e-4) -> tuple:
    """The block's gradient jumps where a pre-activation crosses 0 (the
    kink of leaky), so two fp32 forwards that round differently may take
    different sides there.  Returns (m1, m2, res) changed so that no
    decision lies within ``margin`` of it: the masks drop the elements of
    a1 and a2 that do, and res moves by 1 where ``net + res`` does."""
    from fvt_tpu_torch.ops import tcn as tcn_ops
    a1 = tcn_ops._causal_conv(x, w1, b1, dilation)
    m1 = m1 * (a1.abs() >= margin)
    a2 = tcn_ops._causal_conv(tcn_ops._leaky(a1) * m1, w2, b2, dilation)
    m2 = m2 * (a2.abs() >= margin)
    z = tcn_ops._leaky(a2) * m2 + res
    return m1, m2, res + (z.abs() < margin)


def train_block_shapes(k: int) -> list:
    """(name, B, T, Cin, Cout, dilation) of the 8 blocks of the
    full-width vggish+bert LFAN at the training batch."""
    from fvt_tpu_torch.config import model_config as MC
    shapes = []
    for m in TRAIN_MODALITY:
        cin = MC.EMBEDDING_DIM[m]
        for i, cout in enumerate(MC.TCN_CHANNELS[m]):
            shapes.append((f'{m}.{i}', TRAIN_BATCH, WINDOW, cin, cout,
                           2 ** i))
            cin = cout
    return shapes


def check_train_kernels(device, k: int = 5) -> list:
    """Phase 2, the train-mode block: the forward's output and the
    backward's six results against autograd of the plain version, at the
    8 block shapes of the training path and at edge shapes; times of the
    forward and of the backward alone (on a retained graph)."""
    from fvt_tpu_torch.ops import tcn as tcn_ops

    g = torch.Generator(device=device).manual_seed(SEED + 2)
    names = ('x', 'w1', 'b1', 'w2', 'b2', 'res')
    tot = {key: 0.0 for key in ('fwd_err', 'bwd_err', 'fwd_ms', 'bwd_ms',
                                'fwd_plain', 'bwd_plain', 'fwd_flops',
                                'fwd_bytes', 'bwd_bytes')}
    edge = [('edge T<halo', 2, 7, 64, 64, 8, TCN_DROPOUT),
            ('edge B=3', 3, 300, 128, 64, 1, TCN_DROPOUT),
            ('edge p=0', 2, 90, 48, 96, 4, 0.0),
            ('edge narrow', 1, 1, 20, 8, 2, TCN_DROPOUT)]
    main = [s + (TCN_DROPOUT,) for s in train_block_shapes(k)]
    for name, b, t, cin, cout, d, p in main + edge:
        timed = not name.startswith('edge')

        def randn(*shape, scale=1.0):
            return torch.randn(*shape, device=device, generator=g) * scale

        def mask():
            keep = torch.full((b, t, cout), 1.0 - p, device=device)
            return torch.bernoulli(keep, generator=g) / (1.0 - p)

        a = {'x': randn(b, t, cin),
             'w1': randn(k, cin, cout, scale=(k * cin) ** -0.5),
             'b1': randn(cout, scale=0.1),
             'w2': randn(k, cout, cout, scale=(k * cout) ** -0.5),
             'b2': randn(cout, scale=0.1), 'res': randn(b, t, cout)}
        m1, m2, a['res'] = away_from_kink(
            a['x'], a['w1'], a['b1'], a['w2'], a['b2'], mask(), mask(),
            a['res'], d)
        cot = randn(b, t, cout)
        for v in a.values():
            v.requires_grad_(True)
        args = (a['x'], a['w1'], a['b1'], a['w2'], a['b2'], m1, m2, a['res'])
        kw = dict(kernel_size=k, dilation=d)
        leaves = [a[n] for n in names]
        want = tcn_ops.fused_temporal_block_train_ref(*args, **kw)
        got = tcn_ops.fused_temporal_block_train(*args, **kw)
        label = f'tcn_block_train {name} ({b},{t},{cin})->{cout} d={d}'
        err = compare(label, got.detach(), want.detach())

        def grads(out):
            return torch.autograd.grad(out, leaves, cot, retain_graph=True)

        want_g, got_g = grads(want), grads(got)
        bwd_err = 0.0
        for n, gg, wg in zip(names, got_g, want_g):
            fn = compare if n in ('x', 'res') else compare_sum
            bwd_err = max(bwd_err, fn(f'  tcn_block_bwd d{n}', gg, wg))
        again = grads(got)
        if not all(torch.equal(p1, p2) for p1, p2 in zip(got_g, again)):
            fail(f'{label}: two runs of the backward differ in their bits')
        if not timed:
            continue
        with torch.no_grad():
            fwd = median_ms(
                lambda: tcn_ops.fused_temporal_block_train(*args, **kw))
            fwd_plain = median_ms(
                lambda: tcn_ops.fused_temporal_block_train_ref(*args, **kw))
        bwd, bwd_plain = median_ms(lambda: grads(got)), \
            median_ms(lambda: grads(want))
        print(f'    forward: kernel {fwd:.4f} ms, plain {fwd_plain:.4f} ms; '
              f'backward: kernel {bwd:.4f} ms, plain {bwd_plain:.4f} ms')
        tot['fwd_err'] = max(tot['fwd_err'], err)
        tot['bwd_err'] = max(tot['bwd_err'], bwd_err)
        tot['fwd_ms'] += fwd
        tot['bwd_ms'] += bwd
        tot['fwd_plain'] += fwd_plain
        tot['bwd_plain'] += bwd_plain
        # both convs forward; backward: an input-gradient and a
        # weight-gradient product of the same size for each conv
        tot['fwd_flops'] += 2.0 * b * t * k * (cin + cout) * cout
        tot['fwd_bytes'] += nbytes(*args, got)
        # x w1 w2 m1 m2 res g and the saved a1, a2 in; six results out
        tot['bwd_bytes'] += nbytes(a['x'], a['w1'], a['w2'], m1, m2,
                                   a['res'], cot, got, got, *got_g)
    print(f'  tcn_block_train total over the 8 blocks: forward kernel '
          f'{tot["fwd_ms"]:.4f} ms, plain {tot["fwd_plain"]:.4f} ms; '
          f'backward kernel {tot["bwd_ms"]:.4f} ms, plain '
          f'{tot["bwd_plain"]:.4f} ms')
    source = 'fvt_tpu_torch/csrc/tcn_block_train.cu'
    return [
        {'name': 'tcn_block_train', 'route': 'cuda', 'source': source,
         'replaces': 'fvt_tpu/ops/tcn_pallas.py:143',
         'max_abs_err': tot['fwd_err'], 'ms': tot['fwd_ms'],
         'plain_ms': tot['fwd_plain'], 'library_ms': None,
         **bound(tot['fwd_flops'], tot['fwd_bytes'])},
        {'name': 'tcn_block_bwd', 'route': 'cuda', 'source': source,
         'replaces': 'fvt_tpu/ops/tcn_pallas.py:168',
         'max_abs_err': tot['bwd_err'], 'ms': tot['bwd_ms'],
         'plain_ms': tot['bwd_plain'], 'library_ms': None,
         **bound(2.0 * tot['fwd_flops'], tot['bwd_bytes'])},
    ]


def check_kernels(model, device) -> list:
    """Phase 2: each kernel against its plain version at the serving
    path's shapes, on inputs that flow through the model's own weights."""
    from fvt_tpu_torch.models.layers import fold_batchnorm
    from fvt_tpu_torch.ops import fusion as fusion_ops
    from fvt_tpu_torch.ops import tcn as tcn_ops

    g = torch.Generator(device=device).manual_seed(SEED)
    k = model.temporal[MODALITY[0]].kernel_size
    tcn_err, tcn_ms, tcn_plain_ms = 0.0, 0.0, 0.0
    tcn_flops, tcn_bytes = 0.0, 0
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
                cin, cout = x.shape[-1], want.shape[-1]
                tcn_flops += 2.0 * WINDOW_BATCH * WINDOW * cout * (
                    k * (cin + cout) + (cin if w['wd'] is not None else 0))
                tcn_bytes += nbytes(*args, want)
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
        # per frame: the qkv projections, M x M scores and values per
        # head, o_proj; the softmax and LayerNorm are not counted
        e, nm = fusion.modal_dim, len(MODALITY)
        frames = WINDOW_BATCH * WINDOW
        fusion_flops = 2.0 * frames * (
            sum(feats[m].shape[-1] for m in MODALITY) * 3 * e
            + 2 * nm * nm * e + (e * nm) ** 2)
        fusion_bytes = nbytes(*args[0], *args[1], *args[2], *args[3:]) \
            + frames * e * nm * 4
    print(f'  tcn_block total over the 12 blocks: kernel {tcn_ms:.4f} ms, '
          f'plain {tcn_plain_ms:.4f} ms')
    return [
        {'name': 'tcn_block', 'route': 'cuda',
         'source': 'fvt_tpu_torch/csrc/tcn_block.cu',
         'replaces': 'fvt_tpu/ops/tcn_pallas.py:35',
         'max_abs_err': tcn_err, 'ms': tcn_ms, 'plain_ms': tcn_plain_ms,
         'library_ms': None, **bound(tcn_flops, tcn_bytes)},
        {'name': 'fusion', 'route': 'cuda',
         'source': 'fvt_tpu_torch/csrc/fusion.cu',
         'replaces': 'fvt_tpu/ops/fusion_pallas.py:25',
         'max_abs_err': fusion_err, 'ms': fusion_ms,
         'plain_ms': fusion_plain_ms, 'library_ms': None,
         **bound(fusion_flops, fusion_bytes)},
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
    from fvt_tpu_torch.streaming import StreamingRegistry

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
    from fvt_tpu_torch.data import windowing as W
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


def make_train_batches(n: int) -> list:
    from fvt_tpu_torch.config import model_config as MC
    rng = np.random.default_rng(SEED + 3)
    shape = (TRAIN_BATCH, WINDOW)
    return [{**{m: rng.standard_normal(shape + tuple(MC.FEATURE_DIMENSION[m]),
                                       np.float32) for m in TRAIN_MODALITY},
             'EXPR_continuous_label': rng.integers(0, 7, shape)}
            for _ in range(n)]


def train_lfan(device) -> dict:
    """Phase 4.  Returns the train kernels' launch counts over the fused
    run's TRAIN_STEPS steps."""
    from fvt_tpu_torch.config.defaults import get_train_config
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.ops.fusion import fused_multimodal_fusion
    from fvt_tpu_torch.ops.tcn import (fused_temporal_block,
                                       fused_temporal_block_train as block)
    from fvt_tpu_torch.train.steps import to_device
    from fvt_tpu_torch.train.trainer import Trainer

    config = get_train_config()
    config.update(seed=SEED, nan_guard=True)
    batches = make_train_batches(2)
    epochs = TRAIN_STEPS // len(batches)
    model = LFAN(TRAIN_MODALITY, output_dim=7, tcn_dropout=TCN_DROPOUT,
                 generator=torch.Generator().manual_seed(SEED))
    trainers = {
        'fused': Trainer(copy.deepcopy(model), config, device),
        'plain': Trainer(copy.deepcopy(model), config, device,
                         reference=True),
        'conv-by-conv': Trainer(copy.deepcopy(model), config, device,
                                tcn_fused=False),
    }

    # one step twice from the same state: the gradients' bits
    fused = trainers['fused']
    state = copy.deepcopy(fused.model.state_dict())
    first = to_device(batches[0], device)
    grads = []
    for _ in range(2):
        fused.model.load_state_dict(state)
        fused.model.zero_grad(set_to_none=True)
        fused.train_step.loss(first, fused.step_generator(0, 0)).backward()
        grads.append({n: p.grad.clone()
                      for n, p in fused.train_step.trainable.items()})
    fused.model.load_state_dict(state)
    fused.model.zero_grad(set_to_none=True)
    differ = [n for n in grads[0] if not torch.equal(grads[0][n],
                                                     grads[1][n])]
    print(f'  step 1 twice from one state: {len(grads[0])} gradients, '
          f'{len(differ)} differ in their bits')
    if differ:
        fail(f'gradients differ between two runs of one step: {differ}')

    counters = (fused_temporal_block, fused_multimodal_fusion)
    block.launches_fwd = block.launches_bwd = 0
    eval_before = [c.launches for c in counters]
    losses = {}
    for name in ('fused', 'plain'):
        losses[name] = []
        for e in range(epochs):
            trainers[name].train_one_epoch(batches, e)
            losses[name] += trainers[name].step_losses
        if name == 'fused':
            launches = {'tcn_block_train': block.launches_fwd,
                        'tcn_block_bwd': block.launches_bwd}
    steps = epochs * len(batches)
    print(f'  {steps} steps at ({TRAIN_BATCH},{WINDOW}): fused losses '
          f'{losses["fused"][0]:.6f} .. {losses["fused"][-1]:.6f}; '
          f'tcn_block_train launches {launches["tcn_block_train"]}, '
          f'tcn_block_bwd launches {launches["tcn_block_bwd"]}')
    if not all(np.isfinite(losses['fused'])):
        fail(f'non-finite training loss: {losses["fused"]}')
    if launches != {'tcn_block_train': 8 * steps, 'tcn_block_bwd': 8 * steps}:
        fail(f'expected 8 forward and 8 backward launches a step over '
             f'{steps} steps, got {launches}')
    if [c.launches for c in counters] != eval_before:
        fail('an eval-only kernel was launched while training')
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses['fused'], losses['plain']))
    print(f'  fused vs plain: max relative loss difference {rel:.3e} '
          f'(rtol {TRAIN_LOSS_RTOL})')
    if rel > TRAIN_LOSS_RTOL:
        fail(f'fused and plain training losses differ by {rel}')
    worst = 0.0
    plain_state = trainers['plain'].model.state_dict()
    for n, got in fused.model.state_dict().items():
        want = plain_state[n]
        if not got.is_floating_point():
            continue
        excess = ((got - want).abs() - TRAIN_PARAM_ATOL
                  - TRAIN_PARAM_RTOL * want.abs()).max().item()
        worst = max(worst, (got - want).abs().max().item())
        if excess > 0 or not torch.isfinite(got).all():
            fail(f'{n}: fused and plain training disagree after {steps} '
                 f'steps (rtol {TRAIN_PARAM_RTOL}, atol {TRAIN_PARAM_ATOL})')
    print(f'  final parameters and running statistics: max abs difference '
          f'{worst:.3e} (rtol {TRAIN_PARAM_RTOL}, atol {TRAIN_PARAM_ATOL})')

    frames = TRAIN_BATCH * WINDOW
    for name in ('fused', 'conv-by-conv', 'conv-by-conv', 'fused'):
        tr = trainers[name]
        for _ in range(3):
            tr.train_step(batches[0], tr.step_generator(9, 0))
        torch.cuda.synchronize()
        times = []
        for i in range(RUNS):
            t0 = time.perf_counter()
            tr.train_step(batches[i % 2], tr.step_generator(9, i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        print(f'  {name} step, {RUNS} warm runs from numpy batches: median '
              f'{med * 1e3:.3f} ms, min {min(times) * 1e3:.3f} ms, max '
              f'{max(times) * 1e3:.3f} ms -> {frames / med:.1f} trained '
              f'frames/s')
    return launches


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
          f'summation order; weight and bias gradients '
          f'{WGRAD_TOL} of their largest value)')
    kernels = check_kernels(model, device)
    kernels += check_train_kernels(device)

    print('phase 3: serving through fvt_tpu_torch.streaming')
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
    del model, server, video, crops

    print(f'phase 4: training {"+".join(TRAIN_MODALITY)} through Trainer')
    train_launches = train_lfan(device)
    for kernel in kernels[2:]:
        kernel['launches'] = train_launches[kernel['name']]

    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
