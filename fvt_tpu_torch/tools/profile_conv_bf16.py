"""Splits the bfloat16 3x3 conv kernel's time into its copies and its
products, on the card.

    python3 -m fvt_tpu_torch.tools.profile_conv_bf16 [--frames 2400]
        [--iters 20]

Builds ``csrc/conv3x3_wgmma.cu`` alone three times into ``build/``: as it
is, with ``-DFVT_DIAG_PRODUCTS_ONLY`` (no copy into shared memory is started
or waited for: the ``wgmma`` stream, the barriers and the stores alone) and
with ``-DFVT_DIAG_COPIES_ONLY`` (the products of the first slice only: the
TMA loads, the weight copies and the stores alone).  The two diagnostic
builds give wrong sums; only the first is checked against the plain
version.  Each is timed at the seven stride-1 conv shapes of the ArcFace
body (median of ``--iters`` launches between CUDA events, weights packed
once) beside ``F.conv2d`` on the same bfloat16 tensors (channels_last), and
summed over the 45 convs of a backbone forward.  Prints the card's name and
power limit, the compiler's register report, then one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

# (H = W, Cin, Cout, launches a backbone forward)
CONV_SHAPES = ((40, 64, 64, 6), (40, 64, 128, 1), (20, 128, 128, 6),
               (20, 128, 256, 1), (10, 256, 256, 26), (10, 256, 512, 1),
               (5, 512, 512, 4))
VARIANTS = {'kernel': (), 'products_only': ('-DFVT_DIAG_PRODUCTS_ONLY',),
            'copies_only': ('-DFVT_DIAG_COPIES_ONLY',)}


def build_variants() -> dict:
    """{variant: library}, one nvcc process a variant, all at once."""
    from fvt_tpu_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.CSRC_DIR / 'conv3x3_wgmma.cu'
    paths = {name: build.BUILD_DIR / f'conv3x3_wgmma-{name}.so'
             for name in VARIANTS}
    procs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, *flags, '-shared', '-o',
         str(paths[name]), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        for line in sorted({ln.strip() for ln in log.splitlines()
                            if 'registers' in ln or 'spill' in ln}):
            print(f'  {name}: {line}')
        lib = ctypes.CDLL(str(paths[name]))
        lib.fvt_conv3x3_bf16_forward.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.fvt_conv3x3_bf16_forward.restype = ctypes.c_int
        libs[name] = lib
    return libs


def median_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    from fvt_tpu_torch.ops import conv as conv_ops

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--frames', type=int, default=2400)
    ap.add_argument('--iters', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_conv_bf16: no CUDA device', file=sys.stderr)
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    libs = build_variants()
    device = torch.device('cuda', 0)
    g = torch.Generator(device=device).manual_seed(0)
    n = args.frames
    shapes, total = {}, {name: 0.0 for name in (*VARIANTS, 'conv2d')}
    with torch.inference_mode():
        for h, c, co, count in CONV_SHAPES:
            x = torch.randn(n, h, h, c, device=device,
                            generator=g).bfloat16()
            k = (torch.randn(3, 3, c, co, device=device, generator=g)
                 * (9 * c) ** -0.5).bfloat16()
            packed = conv_ops.pack_weights(k)
            out = torch.empty(n, h, h, co, device=device,
                              dtype=torch.bfloat16)
            stream = torch.cuda.current_stream(device).cuda_stream

            def launch(lib):
                err = lib.fvt_conv3x3_bf16_forward(
                    x.data_ptr(), packed.data_ptr(), out.data_ptr(), n, h, h,
                    c, co, conv_ops.column_tile(co), stream)
                if err:
                    raise RuntimeError(f'launch returned CUDA error {err}')

            launch(libs['kernel'])
            want = conv_ops.conv3x3_ref(x, k).float()
            apart = (out.float() - want).abs()
            if (apart > want.abs() * 2.0 ** -7 + 2.0 ** -9).any():
                raise RuntimeError(f'{h}x{h}x{c}->{co}: the kernel disagrees '
                                   f'with its plain version')
            del want, apart
            flops = 2.0 * 9 * n * h * h * c * co
            row = {}
            for name, lib in libs.items():
                ms = median_ms(lambda: launch(lib), args.iters)
                row[name] = {'ms': round(ms, 4),
                             'tflops': round(flops / ms / 1e9, 1)}
                total[name] += count * ms
            x_cl = x.permute(0, 3, 1, 2)
            w_cl = k.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            ms = median_ms(lambda: F.conv2d(x_cl, w_cl, padding=1),
                           args.iters)
            row['conv2d'] = {'ms': round(ms, 4),
                             'tflops': round(flops / ms / 1e9, 1)}
            total['conv2d'] += count * ms
            # the share of the multiplies that lands on real pixels
            row['real_rows'] = round(h * h / (h + 1) ** 2, 4)
            shapes[f'{h}x{h}x{c}->{co} x{count}'] = row
            del x, k, packed, out, x_cl, w_cl
    print(json.dumps({
        'platform': 'cuda', 'card': card,
        'kind': torch.cuda.get_device_name(0), 'frames': n,
        'iters': args.iters, 'shapes': shapes,
        'ms_over_45_convs': {k: round(v, 4) for k, v in total.items()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
