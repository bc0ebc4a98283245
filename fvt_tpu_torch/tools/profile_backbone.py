"""Times the ArcFace IR-50 backbone's conv paths on the card.

    python3 -m fvt_tpu_torch.tools.profile_backbone [--frames 2400]
        [--iters 10] [--kernels | --stages | --bottleneck [--tiles]]
        [--device cpu] [--dtype float32|bfloat16]

Counterpart of ``tools/profile_backbone.py``.  Three modes, each printing
the card's name and power limit and then one JSON line:

* default: the whole frozen backbone on ``--frames`` 40x40 crops (random
  weights from seed 0) for each path: ``cudnn`` (PyTorch's conv2d),
  ``winograd`` (plain PyTorch Winograd), ``winograd_kernel``,
  ``shifted_kernel``, ``fused_blocks``, ``fused_blocks`` with
  ``shifted_kernel`` or ``winograd_kernel``, ``int8`` (the 41 convs of 128
  input channels or more on the quantise and s8 conv kernels, dynamic
  scales) and ``int8_static`` (calibrated, untimed, on the first 256
  frames, as ``fvt_tpu``'s ``tools/profile_backbone.py:69-81``); ms,
  frames/s, the share of the fp32 peak the model's operations reach, the
  largest difference of the embeddings from ``cudnn``'s and their least
  cosine to it; with ``--kernels`` also where a
  forward's device time goes on each path (``torch.profiler`` over three
  forwards: the sum and the largest kernels by name, ms and launches a
  forward);
* ``--stages``: one 3x3 stride-1 conv at the four stage shapes (40x40x64,
  20x20x128, 10x10x256, 5x5x512) through ``F.conv2d`` (channels_last and
  NCHW), the plain Winograd, the two Winograd kernels (split TF32 on the
  tensor cores, and the earlier one on the CUDA cores) and the
  shifted-products kernel;
* ``--bottleneck``: one identity BottleneckIR block at the four stage
  shapes, the eval block on cuDNN against the fused block's split-TF32
  kernel (the ``fused_blocks`` path; on the card also each of its two
  launches alone, and the plain split-TF32 conv at its own column tile
  and at the block's) and the earlier CUDA-core kernel
  (``bottleneck_ir_fused_simt``); with ``--tiles`` also the CUDA-core
  fused kernel and the CUDA-core conv kernel over a set of block tiles,
  which is where ``ops.bottleneck.MEASURED_TILES`` comes from.

float32 with TF32 off, or with ``--dtype bfloat16`` (the whole-backbone
and ``--stages`` modes) the backbone's bfloat16 compute type, ``--amp`` in
``fvt_tpu``: then the paths with a bfloat16 route run (``cudnn``,
``winograd``, ``winograd_kernel``, which launches the bfloat16 Winograd
kernel, ``shifted_kernel``, which launches the bfloat16 conv kernel,
``fused_blocks`` on either kernel path; ``winograd_simt`` is float32
only), the share is of the tensor cores' bf16 peak, and the embeddings are
compared with the float32 ``cudnn`` path's.  Times are medians of
``--iters`` calls between CUDA events after two warm-up calls.  ``tflops`` and the share of the peak
count the direct convolution's operations for every path, Winograd's too:
they compare times, not the multiplies a path really does.  Runs on the
card unless ``--device cpu`` is given (host-clock times of the plain
versions, for a rehearsal; no share of a peak is printed then).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# published peaks of one H100 SXM: fp32 outside the tensor cores, dense
# bf16 on them
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
STAGES = [(40, 64), (20, 128), (10, 256), (5, 512)]
# block tiles (tf, th, tw) of the shifted-products kernel tried by --tiles,
# per stage extent
CONV_TILES = {40: [(1, 8, 20), (1, 4, 40), (1, 8, 16), (1, 5, 20)],
              20: [(2, 4, 20), (1, 8, 20), (1, 5, 20), (1, 4, 20)],
              10: [(8, 2, 10), (3, 5, 10), (1, 10, 10), (1, 5, 10)],
              5: [(5, 5, 5), (6, 5, 5), (4, 5, 5), (2, 5, 5)]}
# (tf, th, tw, row groups) of the fused block
BLOCK_TILES = {40: [(1, 10, 20, 16), (1, 8, 20, 16), (1, 8, 10, 16),
                    (1, 8, 10, 8)],
               20: [(1, 10, 10, 16), (1, 10, 20, 16), (1, 5, 20, 16),
                    (1, 10, 10, 8), (1, 5, 10, 8)],
               10: [(1, 5, 10, 16), (1, 10, 10, 16), (1, 10, 10, 8),
                    (1, 5, 10, 8), (1, 5, 10, 4), (2, 5, 5, 8)],
               5: [(2, 5, 5, 16), (1, 5, 5, 16), (1, 5, 5, 8), (1, 5, 5, 4),
                   (2, 5, 5, 4)]}


def median_ms(fn, iters: int, device: torch.device) -> float:
    """Median time of ``fn()`` over ``iters`` calls after two warm-up
    calls: CUDA events on the card, the host clock on the CPU."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        if device.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_kernels(fn, top: int = 12, forwards: int = 3) -> dict:
    """Device time of ``fn()`` by kernel, from ``torch.profiler`` over
    ``forwards`` calls: the sum in ms a call, and the ``top`` kernels as
    [name, ms a call, launches a call]."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key[:96], round(e.device_time_total / forwards / 1e3, 4),
                    round(e.count / forwards, 2))
                   for e in prof.key_averages() if e.device_time_total > 0),
                  key=lambda row: -row[1])
    return {'device_ms': round(sum(row[1] for row in rows), 4),
            'kernels': [list(row) for row in rows[:top]]}


def backbone_flops(frames: int) -> float:
    """Multiply-adds times two of one eval forward, from the shapes."""
    from fvt_tpu_torch.models.arcface import get_blocks_50
    total = 2.0 * 9 * 3 * 64 * 40 * 40
    h = 40
    for in_c, depth, stride in get_blocks_50():
        out_h = h // stride
        total += 2.0 * 9 * in_c * depth * h * h          # conv1, stride 1
        total += 2.0 * 9 * depth * depth * out_h * out_h  # conv2
        if in_c != depth:
            total += 2.0 * in_c * depth * out_h * out_h   # 1x1 shortcut
        h = out_h
    total += 2.0 * 512 * 5 * 5 * 512
    return total * frames


def _rate(flops: float, ms: float, device: torch.device,
          dtype: str = 'float32') -> dict:
    out = {'ms': round(ms, 4)}
    if device.type == 'cuda':
        out['tflops'] = round(flops / ms / 1e9, 2)
        share = 'share_of_fp32_peak' if dtype == 'float32' \
            else 'share_of_bf16_peak'
        out[share] = round(flops / (ms * 1e-3) / PEAK_FLOPS[dtype], 4)
    return out


def bench_backbone(frames: int, iters: int, device: torch.device,
                   dtype: str = 'float32', kernels: bool = False) -> dict:
    from fvt_tpu_torch.models.arcface import VisualBackbone

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(frames, 40, 40, 3))
                         .astype(np.float32)).to(device)
    base = VisualBackbone().eval()
    base.reset_parameters(torch.Generator().manual_seed(0))
    flops = backbone_flops(frames)
    variants = [('cudnn', {}), ('winograd', {'conv_impl': 'winograd'}),
                ('winograd_kernel', {'conv_impl': 'winograd_kernel'}),
                ('shifted_kernel', {'conv_impl': 'shifted_kernel'}),
                ('fused_blocks', {'fused_blocks': True}),
                ('fused_blocks+shifted_kernel',
                 {'fused_blocks': True, 'conv_impl': 'shifted_kernel'}),
                ('fused_blocks+winograd_kernel',
                 {'fused_blocks': True, 'conv_impl': 'winograd_kernel'}),
                ('int8', {'conv_impl': 'int8'}),
                ('int8_static', {'conv_impl': 'int8'})]
    results, ref = {}, None
    with torch.inference_mode():
        if dtype != 'float32':
            ref = base.to(device)(x)  # the float32 cudnn path's embeddings
            variants = [(name, {**kw, 'dtype': DTYPES[dtype]})
                        for name, kw in variants]
        for name, kw in variants:
            model = VisualBackbone(**kw).eval()
            model.load_state_dict(base.state_dict())
            model.to(device)
            if name == 'int8_static':
                model.begin_calibration()
                model(x[:256])
                model.end_calibration()
            out = model(x)
            ms = median_ms(lambda: model(x), iters, device)
            if ref is None:
                ref = out
            results[name] = {
                **_rate(flops, ms, device, dtype),
                'frames_per_s': round(frames / ms * 1e3, 1),
                'max_abs_err_vs_cudnn': float((out - ref).abs().max()),
                'min_cosine_vs_cudnn': float((out * ref).sum(1).min())}
            if kernels and device.type == 'cuda':
                results[name].update(device_kernels(lambda: model(x)))
            del model
    return {'gflops_model': round(flops / 1e9, 1), **results}


def _stage_inputs(frames, h, c, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(frames, h, h, c, device=device, generator=g)
    k = torch.randn(3, 3, c, c, device=device, generator=g) * (9 * c) ** -0.5
    return x, k, g


def bench_stages(frames: int, iters: int, device: torch.device,
                 dtype: str = 'float32') -> dict:
    from fvt_tpu_torch.ops import conv as conv_ops
    from fvt_tpu_torch.ops import winograd as winograd_ops

    out = {}
    with torch.inference_mode():
        for h, c in STAGES:
            x, k, _ = _stage_inputs(frames, h, c, device, 1)
            flops = 2.0 * 9 * frames * h * h * c * c
            x, k = x.to(DTYPES[dtype]), k.to(DTYPES[dtype])
            # each kernel's weights derived and packed once, as the module
            # does
            if dtype == 'bfloat16':
                u = winograd_ops.transform_weights_bf16(k)
                packed_u = winograd_ops.pack_winograd_weights_bf16(u)
                packed = conv_ops.pack_weights(k)
            else:
                u = winograd_ops.transform_weights(k)
                packed_u = winograd_ops.pack_winograd_weights_tf32(u)
                packed = None
            winograd_ref = (winograd_ops.conv3x3_winograd_bf16_ref
                            if dtype == 'bfloat16'
                            else winograd_ops.conv3x3_winograd_ref)
            x_cl = x.permute(0, 3, 1, 2)        # NCHW view, channels_last
            x_nchw = x_cl.contiguous()
            w_oihw = k.permute(3, 2, 0, 1).contiguous()
            w_cl = w_oihw.contiguous(memory_format=torch.channels_last)
            paths = [
                ('conv2d_channels_last',
                 lambda: F.conv2d(x_cl, w_cl, padding=1)),
                ('conv2d_nchw', lambda: F.conv2d(x_nchw, w_oihw, padding=1)),
                ('winograd', lambda: winograd_ref(x, k, u)),
                ('winograd_kernel',
                 lambda: winograd_ops.conv3x3_winograd(x, k, u,
                                                       packed=packed_u)),
                ('winograd_simt',
                 lambda: winograd_ops.conv3x3_winograd_simt(x, k, u)),
                ('shifted_kernel',
                 lambda: conv_ops.conv3x3(x, k, packed=packed))]
            if dtype != 'float32':  # the SIMT Winograd is float32 only
                paths = [p for p in paths if p[0] != 'winograd_simt']
            out[f'{h}x{h}x{c}'] = {
                name: _rate(flops, median_ms(fn, iters, device), device,
                            dtype)
                for name, fn in paths}
            del x, k, u, packed_u, x_cl, x_nchw
    return out


def bench_bottleneck(frames: int, iters: int, device: torch.device,
                     tiles: bool) -> dict:
    from fvt_tpu_torch.kernels import build
    from fvt_tpu_torch.ops import bottleneck as block_ops
    from fvt_tpu_torch.ops import conv as conv_ops

    out = {}
    with torch.inference_mode():
        for h, c in STAGES:
            x, w1, g = _stage_inputs(frames, h, c, device, 2)
            w2 = torch.randn(3, 3, c, c, device=device,
                             generator=g) * (9 * c) ** -0.5

            def vec(scale, shift):
                return torch.randn(c, device=device,
                                   generator=g) * scale + shift

            args = (x, w1, w2, vec(0.2, 1.0), vec(0.2, 0.0), vec(0.1, 0.25),
                    vec(0.2, 1.0), vec(0.2, 0.0))
            flops = 2.0 * 2 * 9 * frames * h * h * c * c
            packed = block_ops.pack_block_weights(w1, w2)
            want = block_ops.bottleneck_ir_fused_ref(*args)
            got = block_ops.bottleneck_ir_fused(*args, packed=packed)
            row = {
                'plain_cudnn': _rate(flops, median_ms(
                    lambda: block_ops.bottleneck_ir_fused_ref(*args), iters,
                    device), device),
                'fused': _rate(flops, median_ms(
                    lambda: block_ops.bottleneck_ir_fused(
                        *args, packed=packed), iters, device), device),
                'rel_err': float((got - want).abs().max()
                                 / want.abs().max())}
            if device.type == 'cuda':
                # the split-TF32 kernel's two launches, each alone; beside
                # them the plain split-TF32 conv of x by w1 (no prologue or
                # epilogue, one accumulator) at its own column tile and at
                # the block's
                v, y = torch.empty_like(x), torch.empty_like(x)
                for key, stage in (('conv1', block_ops.CONV1),
                                   ('conv2', block_ops.CONV2)):
                    row[f'fused_{key}_ms'] = round(median_ms(
                        lambda: block_ops.launch_tf32x3(
                            x, packed, args[3:], v, y, stage), iters,
                        device), 4)
                own = conv_ops.pack_weights_tf32(w1)
                row['conv_ms'] = round(median_ms(
                    lambda: conv_ops.conv3x3(x, w1, packed=own), iters,
                    device), 4)
                stream = torch.cuda.current_stream(device).cuda_stream

                def conv_block_bn():
                    build.check(build.library().fvt_conv3x3_tf32x3_forward(
                        x.data_ptr(), packed[0][0].data_ptr(),
                        packed[0][1].data_ptr(), y.data_ptr(), frames, h, h,
                        c, c, block_ops.BLOCK_BN, stream), 'conv3x3')

                row[f'conv_bn{block_ops.BLOCK_BN}_ms'] = round(median_ms(
                    conv_block_bn, iters, device), 4)
                del v, y, own
                row['simt_tile'] = list(block_ops.choose_tile(frames, h, h, c))
                row['fused_simt'] = _rate(flops, median_ms(
                    lambda: block_ops.bottleneck_ir_fused_simt(*args), iters,
                    device), device)
            if tiles and device.type == 'cuda':
                fits = [t for t in BLOCK_TILES[h] if t[0] <= frames
                        and block_ops.conv1_pixels(*t[:3], h, h)
                        <= block_ops.MAX_SLOTS * t[3]
                        and block_ops.smem_floats(*t, c)
                        <= block_ops.MAX_SMEM_FLOATS]
                row['fused_simt_by_tile'] = {
                    'x'.join(map(str, t)): round(median_ms(
                        lambda: block_ops.bottleneck_ir_fused_simt(
                            *args, tile=t), iters, device), 4) for t in fits}
                row['shifted_kernel_by_tile'] = {
                    'x'.join(map(str, t)): round(median_ms(
                        lambda: conv_ops.conv3x3_simt(x, w1, tile=t), iters,
                        device), 4)
                    for t in CONV_TILES[h] if t[0] <= frames}
            out[f'{h}x{h}x{c}'] = row
            del x, w1, w2, args, want, got, packed
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--frames', type=int, default=2400)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--kernels', action='store_true')
    ap.add_argument('--stages', action='store_true')
    ap.add_argument('--bottleneck', action='store_true')
    ap.add_argument('--tiles', action='store_true')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    ap.add_argument('--dtype', default='float32', choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    if args.bottleneck and args.dtype != 'float32':
        ap.error('--bottleneck is float32 only: the fused block has no '
                 'bfloat16 route')
    if args.device == 'cuda' and not torch.cuda.is_available():
        print('profile_backbone: no CUDA device (--device cpu rehearses the '
              'plain versions)', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    report = {'platform': args.device, 'frames': args.frames,
              'dtype': args.dtype, 'iters': args.iters}
    if device.type == 'cuda':
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(card)
        report.update(card=card, kind=torch.cuda.get_device_name(0))
    if args.stages:
        report['stages'] = bench_stages(args.frames, args.iters, device,
                                        args.dtype)
    elif args.bottleneck:
        report['bottleneck'] = bench_bottleneck(args.frames, args.iters,
                                                device, args.tiles)
    else:
        report['backbone'] = bench_backbone(args.frames, args.iters, device,
                                            args.dtype, args.kernels)
    print(json.dumps(report))
    return 0


if __name__ == '__main__':
    sys.exit(main())
