"""Splits a tensor-core 3x3 conv kernel's time into its copies and its
products, on the card.

    python3 -m fvt_tpu_torch.tools.profile_conv_bf16 [--frames 2400]
        [--iters 20]
        [--dtype bfloat16|float32|winograd|winograd_bf16|winograd_bf16_fused
                 |s8|bottleneck_bf16|quantise]
        [--also NAME=SOURCE[:FLAG,...] ...]

Builds the kernel's source alone into ``build/``, once as it is and once
per diagnostic switch: ``-DFVT_DIAG_PRODUCTS_ONLY`` (no copy into shared
memory is started or waited for: the ``wgmma`` stream, the barriers and
the stores alone) and ``-DFVT_DIAG_COPIES_ONLY`` (the products of the
first slice only: the TMA loads, the weight copies and the stores alone).
``--dtype bfloat16`` (default) takes ``csrc/conv3x3_wgmma.cu``;
``--dtype float32`` takes the split-TF32 kernel of
``csrc/conv3x3_tf32x3.cu`` and adds ``-DFVT_DIAG_NO_SPLIT`` (x is not
split into its TF32 parts where it is staged: what the split costs).
``--dtype winograd`` takes the same four builds of the split-TF32 Winograd
kernel, ``csrc/winograd_tf32x3.cu``, and a fifth, ``-DFVT_DIAG_NO_STORE``
(M is not written: what its stores cost), and times its product launch
alone (stage 2, V -> M, on a V the first build's input transform wrote).
``--dtype winograd_bf16`` takes the two-launch bfloat16 Winograd design,
``csrc/winograd_bf16.cu``, in the three builds and ``-DFVT_DIAG_NO_STORE``
(y is not written), and times its product launch alone (stage 2, V -> y
with the output transform in its epilogue, on a V the first build's input
transform wrote).  ``--dtype winograd_bf16_fused`` takes the fused kernel
of the same file (one launch, x -> y) as it is and in four diagnostic
builds: ``-DFVT_DIAG_PRODUCTS_ONLY`` (no copy started or waited for),
``-DFVT_DIAG_NO_FRAGMENTS`` (V formed from no shared-memory read),
``-DFVT_DIAG_NO_PRODUCTS`` (no ``wgmma``), ``-DFVT_DIAG_NO_STORE`` and
``-DFVT_DIAG_NO_GLOBAL_STORE`` (y staged in shared memory, not
written).  ``--dtype s8`` takes the s8 conv of int8 serving,
``csrc/conv3x3_s8_wgmma.cu``, in the three builds, at the eight int8 conv
shapes of the IR-50 (strides 1 and 2, bfloat16 out, weights packed once,
a dynamic scale), checked bit for bit against ``ops.quant.conv3x3_s8_ref``
and summed over the 41 int8 convs of a forward, beside ``F.conv2d`` on
bfloat16; every build is timed in turns (in order, then reversed, the two
medians averaged), and ``--also`` adds builds of other sources of the same
C entry (a variant under study, beside the kernel in one call).
``--dtype bottleneck_bf16`` takes the bfloat16 block kernel of the
fused identity BottleneckIR, ``csrc/bottleneck_bf16_wgmma.cu``, as it is
and in four diagnostic builds
(``-DFVT_DIAG_PRODUCTS_ONLY``, ``-DFVT_DIAG_COPIES_ONLY``,
``-DFVT_DIAG_NO_BN1``: conv1's staged x not rewritten,
``-DFVT_DIAG_NO_GLOBAL_STORE``: no v or y written), beside the earlier
design of the block (two launches of the bfloat16 conv kernel with bn1,
PReLU and bn2 + x fused, ``fvt_bottleneck_bf16_forward``) and that conv
kernel alone on the block's two convs (``fvt_conv3x3_bf16_forward``, B4
bfloat16: the same products with no elementwise work), both from
``csrc/conv3x3_wgmma.cu``, at the IR-50's four identity-block shapes
(weights packed once), each build's block, conv1 and conv2 timed in
turns and summed over the 21 blocks (42 convs) of a forward; the builds
without a diagnostic switch are checked (v within one unit in the last
place of ``bottleneck_bf16_conv1_ref``, y on the plain v of
``bottleneck_bf16_conv2_ref``) and compared bit for bit with the earlier
design's v and y.  ``--dtype quantise`` takes int8 serving's quantisation
pass, ``csrc/quantize_int8_fused.cu``, as it is and in the builds
``-DFVT_DIAG_LOADS_ONLY`` (x read and q written, nothing computed),
``-DFVT_DIAG_NO_PROLOGUE``, ``-DFVT_DIAG_EXACT_DIV`` (the IEEE division
for every value) and ``-DFVT_DIAG_FORWARD_WALK`` (the quantising launch
walks x from its start), beside the earlier design (``fvt_quantize_int8`` of
``csrc/conv3x3_int8.cu``, a memset, an atomic amax launch and a quantise
launch) on the output of the producer run as an op of its own
(``F.batch_norm`` or ``F.prelu`` on the NCHW view, as the float path runs
them), and that producer alone: at the eight int8 conv shapes, each input
with its own producers (bn1 for 20 convs, PReLU for 21), bfloat16 and
float32, dynamic and static (the call's own scale given), every build
timed in turns (``--iters`` calls back to back between CUDA events, the
median of three such bursts) and summed over the 41 convs; the builds whose
switches keep the result (none, ``EXACT_DIV``, ``FORWARD_WALK``, and
``--also`` sources without a ``-DFVT_DIAG`` switch) are checked bit for
bit against
``ops.quant.quantize_int8_ref`` (q, the scale, the amax).  The diagnostic
builds give wrong sums; every other build
(any that ``KERNELS`` lists without a ``-DFVT_DIAG`` switch) is checked
against the plain version (bfloat16, both kernels: one unit in
the last place; float32: rtol = atol = 1e-4; Winograd, all three
launches: 2e-4).  Each is timed at the seven stride-1 conv shapes of the
ArcFace body (median of ``--iters`` launches between CUDA events,
weights packed once) beside ``F.conv2d`` on the same tensors (bfloat16:
channels_last; float32 with TF32 off: the faster of channels_last and
NCHW), and summed over the 45 convs of a backbone forward.  Prints the card's name and
power limit, the compiler's register report, then one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

# (H = W, Cin, Cout, launches a backbone forward)
CONV_SHAPES = ((40, 64, 64, 6), (40, 64, 128, 1), (20, 128, 128, 6),
               (20, 128, 256, 1), (10, 256, 256, 26), (10, 256, 512, 1),
               (5, 512, 512, 4))
DIAG = {'kernel': (), 'products_only': ('-DFVT_DIAG_PRODUCTS_ONLY',),
        'copies_only': ('-DFVT_DIAG_COPIES_ONLY',)}
# per kernel: the source, its C entry, the entry's pointer and int
# arguments before the stream, the diagnostic builds
SPLIT_DIAG = dict(DIAG, no_split=('-DFVT_DIAG_NO_SPLIT',))
KERNELS = {
    'bfloat16': ('conv3x3_wgmma.cu', 'fvt_conv3x3_bf16_forward', 3, 6, DIAG),
    'float32': ('conv3x3_tf32x3.cu', 'fvt_conv3x3_tf32x3_forward', 4, 6,
                SPLIT_DIAG),
    'winograd': ('winograd_tf32x3.cu', 'fvt_winograd_tf32x3_forward', 6, 7,
                 dict(SPLIT_DIAG, no_store=('-DFVT_DIAG_NO_STORE',))),
    'winograd_bf16': ('winograd_bf16.cu', 'fvt_winograd_bf16_forward', 4, 6,
                      dict(DIAG, no_store=('-DFVT_DIAG_NO_STORE',))),
    's8': ('conv3x3_s8_wgmma.cu', 'fvt_conv3x3_s8_forward', 5, 7, DIAG),
    'bottleneck_bf16': (
        'bottleneck_bf16_wgmma.cu', 'fvt_bottleneck_bf16_wgmma_forward', 10,
        5, {'kernel': (), 'products_only': ('-DFVT_DIAG_PRODUCTS_ONLY',),
            'copies_only': ('-DFVT_DIAG_COPIES_ONLY',),
            'no_bn1': ('-DFVT_DIAG_NO_BN1',),
            'no_global_store': ('-DFVT_DIAG_NO_GLOBAL_STORE',)}),
    'winograd_bf16_fused': (
        'winograd_bf16.cu', 'fvt_winograd_bf16_fused_forward', 3, 5,
        {'kernel': (), 'products_only': ('-DFVT_DIAG_PRODUCTS_ONLY',),
         'no_fragments': ('-DFVT_DIAG_NO_FRAGMENTS',),
         'no_products': ('-DFVT_DIAG_NO_PRODUCTS',),
         'no_store': ('-DFVT_DIAG_NO_STORE',),
         'no_global_store': ('-DFVT_DIAG_NO_GLOBAL_STORE',)}),
    'quantise': (
        'quantize_int8_fused.cu', 'fvt_quantize_int8_fused', 0, 0,
        {'kernel': (), 'loads_only': ('-DFVT_DIAG_LOADS_ONLY',),
         'no_prologue': ('-DFVT_DIAG_NO_PROLOGUE',),
         'exact_div': ('-DFVT_DIAG_EXACT_DIV',),
         'forward_walk': ('-DFVT_DIAG_FORWARD_WALK',)}),
}
# the quantise pass's diagnostic switches that keep the result: checked,
# as every build without a -DFVT_DIAG switch is
QUANTISE_EXACT = ('-DFVT_DIAG_EXACT_DIV', '-DFVT_DIAG_FORWARD_WALK')


def build_variants(source: str, entry: str, pointers: int, ints: int,
                   variants: dict, others: dict = None) -> dict:
    """{variant: C entry}: ``csrc/<source>`` built once a variant (its
    nvcc flags), and each of ``others`` ({name: (source path, flags)}),
    one nvcc process a build, all at once, and the entry bound with its
    pointer and int arguments before the stream."""
    from fvt_tpu_torch.kernels import build

    src = build.CSRC_DIR / source
    builds = {name: (src, flags) for name, flags in variants.items()}
    builds.update(others or {})
    return {name: bind(lib, entry, pointers, ints)
            for name, lib in build_libs(builds).items()}


def bind(lib: ctypes.CDLL, entry: str, pointers: int, ints: int):
    """The C entry of ``lib`` with its pointer and int arguments before
    the stream."""
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build_libs(builds: dict) -> dict:
    """{name: library}: each of ``builds`` ({name: (source path, nvcc
    flags)}) built by one nvcc process, all at once, into ``build/``;
    prints each build's register and spill report."""
    from fvt_tpu_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: build.BUILD_DIR / f'{Path(path).stem}-{name}.so'
             for name, (path, _) in builds.items()}
    procs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, *flags, '-I', str(build.CSRC_DIR),
         '-shared', '-o', str(paths[name]), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (path, flags) in builds.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        for line in sorted({ln.strip() for ln in log.splitlines()
                            if 'registers' in ln or 'spill' in ln
                            or 'Performance Loss' in ln}):
            print(f'  {name}: {line}')
        libs[name] = ctypes.CDLL(str(paths[name]))
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


def burst_ms(fn, calls: int, repeats: int = 3) -> float:
    """ms a call of ``calls`` calls back to back between two CUDA events
    (the launches queue up, so the host's time a call hides behind the
    device's), the median of ``repeats`` bursts."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# the int8 convs of the IR-50: (H = W, Cin, Cout, stride, convs a forward)
S8_SHAPES = ((40, 128, 128, 2, 1), (20, 128, 128, 1, 6), (20, 128, 256, 1, 1),
             (20, 256, 256, 2, 1), (10, 256, 256, 1, 26),
             (10, 256, 512, 1, 1), (10, 512, 512, 2, 1), (5, 512, 512, 1, 4))


def profile_s8(fns: dict, checked: list, n: int, iters: int) -> dict:
    """The s8 conv's builds at S8_SHAPES on n frames: bit for bit the plain
    version (the builds named in ``checked``; a build of another source that
    differs is reported and left out), each timed in turns, beside
    ``F.conv2d`` on bfloat16; the shapes' rows and the totals over the 41
    convs."""
    from fvt_tpu_torch.ops import quant

    device = torch.device('cuda', 0)
    g = torch.Generator(device=device).manual_seed(0)
    shapes, total = {}, {name: 0.0 for name in (*fns, 'conv2d')}
    stream = torch.cuda.current_stream(device).cuda_stream
    wrong = {}
    with torch.inference_mode():
        for h, c, co, stride, count in S8_SHAPES:
            x = torch.randn(n, h, h, c, device=device,
                            generator=g).bfloat16()
            k = (torch.randn(3, 3, c, co, device=device, generator=g)
                 * (9 * c) ** -0.5)
            wq, wscale = quant.quantize_weights(k)
            wp = quant.pack_weights_s8(wq)
            xq, scale, _ = quant.quantize_int8(x)
            ho = quant.out_size(h, stride)
            out = torch.empty(n, ho, ho, co, device=device,
                              dtype=torch.bfloat16)

            def launch(fn):
                err = fn(xq.data_ptr(), wp.data_ptr(), wscale.data_ptr(),
                         scale.data_ptr(), out.data_ptr(), 1, n, h, h, c, co,
                         stride, stream)
                if err:
                    raise RuntimeError(f'launch returned CUDA error {err}')

            want = quant.conv3x3_s8_ref(xq, scale, wq, wscale, stride,
                                        torch.bfloat16)
            for name in checked:
                if name in wrong:
                    continue
                out.zero_()
                launch(fns[name])
                if torch.equal(out, want):
                    continue
                what = (f'{h}x{h}x{c}->{co} s{stride}: the {name} build '
                        f'differs from its plain version')
                if name in DIAG:
                    raise RuntimeError(what)
                wrong[name] = what
                print(f'  {what}: left out', flush=True)
            del want
            ops = quant.s8_conv_ops(n, h, h, c, co, stride)
            timed = [name for name in fns if name not in wrong]
            row, turns = {}, {name: [] for name in timed}
            for order in (timed, timed[::-1]):
                for name in order:
                    turns[name].append(median_ms(lambda: launch(fns[name]),
                                                 iters))
            for name, times in turns.items():
                ms = statistics.mean(times)
                row[name] = {'ms': round(ms, 4),
                             'tops': round(ops / ms / 1e9, 1)}
                total[name] += count * ms
            x_cl = x.permute(0, 3, 1, 2)
            w_cl = k.bfloat16().permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            ms = median_ms(lambda: F.conv2d(x_cl, w_cl, None, stride, 1),
                           iters)
            row['conv2d'] = {'ms': round(ms, 4)}
            total['conv2d'] += count * ms
            row['route'] = quant.s8_plan(n, h, h, c, co, stride)['route']
            # the share of the multiplies that lands on real pixels
            row['real_rows'] = round(
                h * h / (h + 1) ** 2 if row['route'] == 'padded' else 1.0, 4)
            shapes[f'{h}x{h}x{c}->{co} s{stride} x{count}'] = row
            del x, k, wq, wp, xq, out, x_cl, w_cl
    return {'shapes': shapes, 'wrong': wrong,
            'ms_over_41_convs': {k: round(v, 4) for k, v in total.items()
                                 if k not in wrong}}


# the IR-50's identity blocks: (H = W, C, blocks a forward)
BLOCK_SHAPES = ((40, 64, 3), (20, 128, 3), (10, 256, 13), (5, 512, 2))


def profile_block(fns: dict, checked: list, conv_design, conv, n: int,
                  iters: int) -> dict:
    """The bfloat16 block kernel's builds (``fns``), the earlier design
    (``conv_design``, ``fvt_bottleneck_bf16_forward``) and the bfloat16
    conv kernel alone on the block's two convs (``conv``) at BLOCK_SHAPES
    on n frames: the checks of the module docstring, then each one's
    block, conv1 and conv2 timed in turns; the shapes' rows and the totals
    over the 21 blocks.  ``checked`` names the builds held to the plain
    version."""
    from fvt_tpu_torch.ops import bottleneck as block_ops
    from fvt_tpu_torch.ops import conv as conv_ops

    device = torch.device('cuda', 0)
    g = torch.Generator(device=device).manual_seed(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    names = [*fns, 'conv_design', 'b4_convs']
    parts = ('block', 'conv1', 'conv2')
    total = {name: dict.fromkeys(parts, 0.0) for name in names}
    shapes, bit_equal = {}, {}
    with torch.inference_mode():
        for h, c, count in BLOCK_SHAPES:
            def randn(*shape, scale=1.0, shift=0.0):
                return torch.randn(*shape, device=device,
                                   generator=g) * scale + shift
            x = randn(n, h, h, c).bfloat16()
            w1, w2 = (randn(3, 3, c, c, scale=(9 * c) ** -0.5).bfloat16()
                      for _ in range(2))
            vecs = (randn(c, scale=0.2, shift=1.0), randn(c, scale=0.5),
                    randn(c, scale=0.1, shift=0.25),
                    randn(c, scale=0.2, shift=1.0), randn(c, scale=0.5))
            packed = block_ops.pack_block_weights_bf16(w1, w2)
            v, y = torch.empty_like(x), torch.empty_like(x)
            bn = conv_ops.column_tile(c)

            def ptrs(v_, y_):
                return (x.data_ptr(), *(t.data_ptr() for t in packed),
                        *(t.data_ptr() for t in vecs), v_.data_ptr(),
                        y_.data_ptr())

            def launch(name, stages, v_=v, y_=y):
                if name == 'conv_design':
                    err = conv_design(*ptrs(v_, y_), n, h, h, c, bn, stages,
                                      stream)
                elif name == 'b4_convs':  # conv1 x -> v, conv2 v -> y
                    err = 0
                    if stages & 1:
                        err = conv(x.data_ptr(), packed[0].data_ptr(),
                                   v_.data_ptr(), n, h, h, c, c, bn, stream)
                    if stages & 2 and not err:
                        err = conv(v_.data_ptr(), packed[1].data_ptr(),
                                   y_.data_ptr(), n, h, h, c, c, bn, stream)
                else:
                    err = fns[name](*ptrs(v_, y_), n, h, h, c, stages,
                                    stream)
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')

            # the checks: v and y (on the plain v) within one unit in the
            # last place of the plain version, and against the earlier
            # design's bit for bit
            v_plain = block_ops.bottleneck_bf16_conv1_ref(x, w1, *vecs[:3])
            y_plain = block_ops.bottleneck_bf16_conv2_ref(v_plain, x, w2,
                                                          *vecs[3:])
            v_old, y_old = torch.empty_like(x), torch.empty_like(x)
            launch('conv_design', block_ops.CONV1, v_old, y_old)
            launch('conv_design', block_ops.CONV2, v_plain, y_old)
            key = f'{h}x{h}x{c} x{count}'
            for name in checked:
                launch(name, block_ops.CONV1)
                launch(name, block_ops.CONV2, v_plain, y)
                for what, got, want in (('v', v, v_plain), ('y', y, y_plain)):
                    apart = (got.float() - want.float()).abs()
                    if (apart > want.float().abs() * 2.0 ** -7
                            + 2.0 ** -9).any():
                        raise RuntimeError(f'{key}: the {name} build\'s '
                                           f'{what} disagrees with its '
                                           f'plain version')
                bit_equal[f'{name} {key}'] = [torch.equal(v, v_old),
                                              torch.equal(y, y_old)]
            del v_plain, y_plain, v_old, y_old
            flops = 2 * 2.0 * 9 * n * h * h * c * c
            turns = {name: {part: [] for part in parts} for name in names}
            for order in (names, names[::-1]):
                for name in order:
                    for part, stages in zip(parts, (block_ops.BOTH,
                                                    block_ops.CONV1,
                                                    block_ops.CONV2)):
                        turns[name][part].append(median_ms(
                            lambda: launch(name, stages), iters))
            row = {}
            for name, times in turns.items():
                row[name] = {part: round(statistics.mean(t), 4)
                             for part, t in times.items()}
                row[name]['tflops'] = round(
                    flops / statistics.mean(times['block']) / 1e9, 1)
                for part, t in times.items():
                    total[name][part] += count * statistics.mean(t)
            row['bound_ms'] = round(flops / 989e12 * 1e3, 4)
            # the share of the multiplies that lands on real pixels
            row['real_rows'] = round(h * h / (h + 1) ** 2, 4)
            shapes[key] = row
            del x, w1, w2, vecs, packed, v, y
    return {'shapes': shapes, 'bit_equal_conv_design': bit_equal,
            'ms_over_21_blocks': {
                name: {part: round(ms, 4) for part, ms in parts_.items()}
                for name, parts_ in total.items()},
            'bound_ms_over_21_blocks': round(sum(
                count * 2 * 2.0 * 9 * n * h * h * c * c
                for h, c, count in BLOCK_SHAPES) / 989e12 * 1e3, 4)}


# the producers of the int8 convs' inputs by S8_SHAPES row: (bn1-fed,
# PReLU-fed) convs, 20 and 21 in all
PRODUCERS = ((0, 1), (3, 3), (1, 0), (0, 1), (13, 13), (1, 0), (0, 1),
             (2, 2))


def bind_quantise(lib: ctypes.CDLL, entry: str):
    """The fused pass's C entry (x, bf16, n, C, prologue, p0, p1, p2,
    scale_in, words, q, stream) or the earlier one's (x, bf16, n, amax,
    scale_in, scale_out, q, stream)."""
    fn = getattr(lib, entry)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([p, i, ll, i, i] + [p] * 7
                   if entry == 'fvt_quantize_int8_fused'
                   else [p, i, ll] + [p] * 5)
    fn.restype = ctypes.c_int
    return fn


def profile_quantise(fns: dict, atomic, checked: list, n: int,
                     iters: int) -> dict:
    """The fused quantise pass's builds (``fns``), the earlier design
    (``atomic``) on the producer's output and the producer alone at
    S8_SHAPES on n frames, bfloat16 and float32: the checks and the timings
    of the module docstring; the shapes' rows, the totals over the 41
    convs and the bound (x read once, q written once)."""
    from fvt_tpu_torch.models.arcface import bn_terms
    from fvt_tpu_torch.ops import quant

    device = torch.device('cuda', 0)
    g = torch.Generator(device=device).manual_seed(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    names = [*fns, 'atomic', 'producer']
    shapes, wrong = {}, {}
    total = {dt: {name: {'dynamic': 0.0, 'static': 0.0} for name in names}
             for dt in ('bfloat16', 'float32')}
    bound = dict.fromkeys(total, 0.0)
    with torch.inference_mode():
        for (h, c, _, stride, _), counts in zip(S8_SHAPES, PRODUCERS):
            bn = torch.nn.BatchNorm2d(c).to(device).requires_grad_(False)
            for t, lo, hi in ((bn.weight, 0.5, 1.5), (bn.bias, -0.5, 0.5),
                              (bn.running_mean, -0.5, 0.5),
                              (bn.running_var, 0.2, 2.0)):
                t.copy_(torch.rand(c, device=device, generator=g)
                        * (hi - lo) + lo)
            alpha = torch.rand(c, device=device, generator=g) - 0.5
            for dtype in (torch.bfloat16, torch.float32):
                dt = str(dtype)[6:]
                x = torch.randn(n, h, h, c, device=device, generator=g
                                ).to(dtype)
                x.view(-1)[7] = 9.0
                nchw = x.permute(0, 3, 1, 2)
                q = torch.empty(x.shape, dtype=torch.int8, device=device)
                words = torch.empty(2 + quant.MAX_PARTS, device=device)
                bf16 = int(dtype == torch.bfloat16)
                for kind, convs in zip(('bn1', 'prelu'), counts):
                    if not convs:
                        continue
                    prologue = (('bn1', *bn_terms(bn, bn.running_mean,
                                                  bn.running_var, dtype))
                                if kind == 'bn1'
                                else ('prelu', alpha.to(dtype)))
                    ptrs = [t.data_ptr() for t in prologue[1:]]
                    ptrs += [None] * (3 - len(ptrs))

                    def producer():
                        # the op the float path runs (arcface.py
                        # batchnorm_eval, prelu_as)
                        if kind == 'bn1':
                            return F.batch_norm(
                                nchw, bn.running_mean, bn.running_var,
                                bn.weight, bn.bias, False, 0.0, bn.eps)
                        return F.prelu(nchw, prologue[1])

                    want_q, scale, amax = quant.quantize_int8_ref(
                        x, None, prologue)
                    made = producer().permute(0, 2, 3, 1)

                    def launch(name, static):
                        sin = scale.data_ptr() if static else None
                        if name == 'producer':
                            producer()
                            return
                        if name == 'atomic':
                            err = atomic(made.data_ptr(), bf16, made.numel(),
                                         None if static
                                         else words.data_ptr(), sin,
                                         None if static
                                         else words[1:].data_ptr(),
                                         q.data_ptr(), stream)
                        else:
                            err = fns[name](x.data_ptr(), bf16, x.numel(), c,
                                            quant.PROLOGUES[kind][0], *ptrs,
                                            sin, words.data_ptr(),
                                            q.data_ptr(), stream)
                        if err:
                            raise RuntimeError(f'{name}: CUDA error {err}')

                    key = f'{h}x{h}x{c} s{stride} {kind} x{convs} {dt}'
                    for name in checked:
                        if (name, dt) in wrong:
                            continue
                        apart = []
                        for static in (False, True):
                            q.zero_()
                            launch(name, static)
                            torch.cuda.synchronize()
                            bad = int((q != want_q).sum())
                            if bad:
                                apart.append(f'{"static" if static else "dynamic"}'
                                             f' {bad} q apart')
                            if not static and not (
                                    torch.equal(words[:1], amax)
                                    and torch.equal(words[1:2], scale)):
                                apart.append(f'amax {words[0].item()} '
                                             f'(plain {amax.item()})')
                        if not apart:
                            continue
                        what = (f'{key}: the {name} build differs from its '
                                f'plain version ({", ".join(apart)})')
                        if name == 'kernel':
                            raise RuntimeError(what)
                        # another design or source: reported, left out of
                        # this type's timings
                        wrong[name, dt] = what
                        print(f'  {what}: left out', flush=True)
                    runs = [(name, mode) for name in names
                            if (name, dt) not in wrong
                            for mode in ('dynamic', 'static')
                            if name != 'producer' or mode == 'dynamic']
                    turns = {run: [] for run in runs}
                    for order in (runs, runs[::-1]):
                        for name, mode in order:
                            turns[name, mode].append(burst_ms(
                                lambda: launch(name, mode == 'static'),
                                iters))
                    row = {}
                    for (name, mode), times in turns.items():
                        ms = statistics.mean(times)
                        row.setdefault(name, {})[mode] = round(ms, 4)
                        total[dt][name][mode] += convs * ms
                    # x read once, q written once
                    row['bound_ms'] = round(x.numel() * (x.element_size() + 1)
                                            / 3.35e12 * 1e3, 4)
                    bound[dt] += convs * row['bound_ms']
                    shapes[key] = row
                    del made, want_q
                del x, nchw, q
    out = {}
    for dt, builds in total.items():
        rows = {name: {mode: round(ms, 4) for mode, ms in modes.items()
                       if name != 'producer' or mode == 'dynamic'}
                for name, modes in builds.items() if (name, dt) not in wrong}
        # today's composition: the producer, then the atomic pass
        rows['unfused'] = {
            mode: round(builds['atomic'][mode]
                        + builds['producer']['dynamic'], 4)
            for mode in ('dynamic', 'static')}
        rows['bound'] = round(bound[dt], 4)
        out[dt] = rows
    return {'shapes': shapes, 'wrong': list(wrong.values()),
            'ms_over_41_convs': out}


def main(argv=None) -> int:
    from fvt_tpu_torch.ops import conv as conv_ops
    from fvt_tpu_torch.ops import winograd as winograd_ops

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--frames', type=int, default=2400)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--dtype', default='bfloat16', choices=sorted(KERNELS))
    ap.add_argument('--also', action='append', default=[],
                    metavar='NAME=SOURCE[:FLAG,...]',
                    help='s8, bottleneck_bf16, quantise: a build of another '
                         'source of the same C entry, timed beside')
    args = ap.parse_args(argv)
    others = {}
    for spec in args.also:
        name, _, rest = spec.partition('=')
        path, _, flags = rest.partition(':')
        others[name] = (path, tuple(f for f in flags.split(',') if f))
    if others and args.dtype not in ('s8', 'bottleneck_bf16', 'quantise'):
        ap.error('--also is for --dtype s8, bottleneck_bf16 and quantise')
    if not torch.cuda.is_available():
        print('profile_conv_bf16: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    if args.dtype == 'bottleneck_bf16':
        from fvt_tpu_torch.kernels import build

        source, entry, pointers, ints, variants = KERNELS[args.dtype]
        builds = {name: (build.CSRC_DIR / source, flags)
                  for name, flags in variants.items()}
        builds.update(others)
        builds['conv_design'] = (build.CSRC_DIR / 'conv3x3_wgmma.cu', ())
        libs = build_libs(builds)
        fns = {name: bind(libs[name], entry, pointers, ints)
               for name in builds if name != 'conv_design'}
        lib = libs['conv_design']
        checked = [name for name, (_, flags) in builds.items()
                   if name != 'conv_design'
                   and not any(f.startswith('-DFVT_DIAG') for f in flags)]
        print(json.dumps({
            'platform': 'cuda', 'card': card,
            'kind': torch.cuda.get_device_name(0), 'dtype': args.dtype,
            'frames': args.frames, 'iters': args.iters,
            'also': {k: [str(v[0]), *v[1]] for k, v in others.items()},
            **profile_block(
                fns, checked, bind(lib, 'fvt_bottleneck_bf16_forward', 10, 6),
                bind(lib, 'fvt_conv3x3_bf16_forward', 3, 6), args.frames,
                args.iters)}))
        return 0
    if args.dtype == 'quantise':
        from fvt_tpu_torch.kernels import build

        source, entry, _, _, variants = KERNELS[args.dtype]
        builds = {name: (build.CSRC_DIR / source, flags)
                  for name, flags in variants.items()}
        builds.update(others)
        builds['atomic'] = (build.CSRC_DIR / 'conv3x3_int8.cu', ())
        libs = build_libs(builds)
        fns = {name: bind_quantise(lib, entry) for name, lib in libs.items()
               if name != 'atomic'}
        checked = [name for name, (_, flags) in builds.items()
                   if name != 'atomic' and all(
                       f in QUANTISE_EXACT or not f.startswith('-DFVT_DIAG')
                       for f in flags)]
        print(json.dumps({
            'platform': 'cuda', 'card': card,
            'kind': torch.cuda.get_device_name(0), 'dtype': args.dtype,
            'frames': args.frames, 'iters': args.iters,
            'also': {k: [str(v[0]), *v[1]] for k, v in others.items()},
            **profile_quantise(
                fns, bind_quantise(libs['atomic'], 'fvt_quantize_int8'),
                checked, args.frames, args.iters)}))
        return 0
    fns = build_variants(*KERNELS[args.dtype], others)
    if args.dtype == 's8':
        checked = [name for name, flags in (
            *DIAG.items(), *((k, v[1]) for k, v in others.items()))
            if not any(f.startswith('-DFVT_DIAG') for f in flags)]
        print(json.dumps({
            'platform': 'cuda', 'card': card,
            'kind': torch.cuda.get_device_name(0), 'dtype': args.dtype,
            'frames': args.frames, 'iters': args.iters,
            'also': {k: [v[0], *v[1]] for k, v in others.items()},
            **profile_s8(fns, checked, args.frames, args.iters)}))
        return 0
    fused = args.dtype == 'winograd_bf16_fused'
    bf16 = args.dtype in ('bfloat16', 'winograd_bf16', 'winograd_bf16_fused')
    winograd = args.dtype in ('winograd', 'winograd_bf16')
    device = torch.device('cuda', 0)
    g = torch.Generator(device=device).manual_seed(0)
    n = args.frames
    shapes, total = {}, {name: 0.0 for name in (*fns, 'conv2d')}
    with torch.inference_mode():
        for h, c, co, count in CONV_SHAPES:
            x = torch.randn(n, h, h, c, device=device, generator=g)
            k = (torch.randn(3, 3, c, co, device=device, generator=g)
                 * (9 * c) ** -0.5)
            if bf16:
                x, k = x.bfloat16(), k.bfloat16()
            if args.dtype == 'bfloat16':
                weights = [conv_ops.pack_weights(k)]
            elif fused:  # packed U, no workspace
                weights = [winograd_ops.pack_winograd_weights_bf16(
                    winograd_ops.transform_weights_bf16(k))]
            elif args.dtype == 'winograd_bf16':  # packed U, workspace V
                weights = [winograd_ops.pack_winograd_weights_bf16(
                    winograd_ops.transform_weights_bf16(k)),
                    winograd_ops.workspace_bf16(x)]
            elif winograd:  # U's parts, then the workspace V and M
                weights = [*winograd_ops.pack_winograd_weights_tf32(
                    winograd_ops.transform_weights(k)),
                    *winograd_ops.workspace(x, co)]
            else:
                weights = list(conv_ops.pack_weights_tf32(k))
            out = torch.empty(n, h, h, co, device=device, dtype=x.dtype)
            stream = torch.cuda.current_stream(device).cuda_stream
            # Winograd: all its launches, then the product alone; the
            # bfloat16 Winograd entry takes no column tile
            stages = [[winograd_ops.BF16_STAGES if bf16
                       else winograd_ops.ALL_STAGES],
                      [winograd_ops.PRODUCT]] if winograd else [[], []]
            bn = [] if args.dtype.startswith('winograd_bf16') else [
                conv_ops.column_tile(co)]

            def launch(fn, stage):
                err = fn(x.data_ptr(), *(w.data_ptr() for w in weights),
                         out.data_ptr(), n, h, h, c, co, *bn, *stage,
                         stream)
                if err:
                    raise RuntimeError(f'launch returned CUDA error {err}')

            ref = (winograd_ops.conv3x3_winograd_bf16_ref
                   if args.dtype.startswith('winograd_bf16')
                   else winograd_ops.conv3x3_winograd_ref if winograd
                   else conv_ops.conv3x3_ref)
            want = ref(x, k).float()
            rtol, atol = ((2.0 ** -7, 2.0 ** -9) if bf16 else
                          (2e-4, 2e-4) if winograd else (1e-4, 1e-4))
            for name, flags in KERNELS[args.dtype][4].items():
                if any(f.startswith('-DFVT_DIAG') for f in flags):
                    continue  # wrong sums by design
                launch(fns[name], stages[0])
                apart = (out.float() - want).abs()
                if (apart > want.abs() * rtol + atol).any():
                    raise RuntimeError(f'{h}x{h}x{c}->{co}: the {name} build '
                                       f'disagrees with its plain version')
                del apart
            del want
            flops = 2.0 * 9 * n * h * h * c * co
            row = {}
            for name, fn in fns.items():
                ms = median_ms(lambda: launch(fn, stages[1]), args.iters)
                row[name] = {'ms': round(ms, 4),
                             'tflops': round(flops / ms / 1e9, 1)}
                total[name] += count * ms
            x_cl = x.permute(0, 3, 1, 2)
            w_oihw = k.permute(3, 2, 0, 1).contiguous()
            w_cl = w_oihw.contiguous(memory_format=torch.channels_last)
            ms = median_ms(lambda: F.conv2d(x_cl, w_cl, padding=1),
                           args.iters)
            if not bf16:  # float32: the faster layout
                x_nchw = x_cl.contiguous()
                ms = min(ms, median_ms(
                    lambda: F.conv2d(x_nchw, w_oihw, padding=1), args.iters))
                del x_nchw
            row['conv2d'] = {'ms': round(ms, 4),
                             'tflops': round(flops / ms / 1e9, 1)}
            total['conv2d'] += count * ms
            # the share of the multiplies that lands on real pixels
            row['real_rows'] = round(
                h * h / (2 * ((h + 1) // 2)) ** 2 if winograd or fused
                else h * h / (h + 1) ** 2, 4)
            shapes[f'{h}x{h}x{c}->{co} x{count}'] = row
            del x, k, weights, out, x_cl, w_cl, w_oihw
    print(json.dumps({
        'platform': 'cuda', 'card': card,
        'kind': torch.cuda.get_device_name(0), 'dtype': args.dtype,
        'frames': n, 'iters': args.iters, 'shapes': shapes,
        'ms_over_45_convs': {k: round(v, 4) for k, v in total.items()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
