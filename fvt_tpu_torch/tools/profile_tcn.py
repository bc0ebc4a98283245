"""The split-TF32 eval TCN block (B1) on the card, by launch, device time
and host time.

    python3 -m fvt_tpu_torch.tools.profile_tcn [--runs 20] [--diag | --serve]

At the 12 block shapes of a tri-modal LFAN's serving dispatch (8 windows
of 300 frames; video 512, vggish 128 and bert 768 channels in; weights
and inputs random from seed 0): the kernel's largest difference from the
plain version, its time (CUDA events, median of ``--runs``) and each of
its launches alone (conv1, the downsample, conv2); beside them the
earlier CUDA-core kernel's and the plain version's time; the device time
of each launch (``torch.profiler`` over ``--runs`` passes), which leaves
out the host's time between launches; and the host time of a call, split
into the wrapper's own work (its argument checks, the ``torch.empty`` of
out, h and r, the channel pad), ``launch_tf32x3``'s tensor checks and
the C entry's (three tensor-map encodes and launches at most).  Then the
device time of the 12 blocks by kernel, and what one
``cuTensorMapEncodeTiled``, one ``torch.empty`` of (8, 300, 256) and a
call of the C entry that it refuses at once take on the host.
``--diag`` instead builds ``csrc/tcn_block_tf32x3.cu`` alone as it is
and once per diagnostic switch (``-DFVT_DIAG_PRODUCTS_ONLY``,
``-DFVT_DIAG_COPIES_ONLY``, ``-DFVT_DIAG_NO_SPLIT``: the kernel's header
note; they give wrong sums) and prints each build's device time of the 12
blocks by launch.  ``--serve`` times full (8, 300) dispatches of a
tri-modal LFAN (random weights from seed 0) on
``conv_impl='shifted_kernel'``, in float32 and with a bfloat16 backbone,
with the eval TCN blocks on the split-TF32 kernel and on the CUDA-core
one (``fused_temporal_block_simt`` put in its place), in turns: the
kernel's effect on a served dispatch.  Ends with one JSON line.  Needs a
CUDA card; float32 with TF32 off.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time

import torch

MODALITY = ('video', 'vggish', 'bert')
BATCH, WINDOW, K, SEED = 8, 300, 5, 0


def median_ms(fn, runs: int) -> float:
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


def block_shapes() -> list:
    """(name, Cin, Cout, dilation) of the 12 blocks."""
    from fvt_tpu_torch.config import model_config as MC
    shapes = []
    for m in MODALITY:
        cin = MC.EMBEDDING_DIM[m]
        for i, cout in enumerate(MC.TCN_CHANNELS[m]):
            shapes.append((f'{m}.{i}', cin, cout, 2 ** i))
            cin = cout
    return shapes


def device_ms(passes: list, runs: int) -> dict:
    """Device ms a pass of ``passes`` (callables that launch), by kernel
    name, from ``torch.profiler`` over ``runs`` passes."""
    from torch.profiler import ProfilerActivity, profile

    for fn in passes:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            for fn in passes:
                fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 1e3 / runs
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0}


# what each instantiation of the kernel launches, by its Epilogue
LAUNCHES = {'Epilogue)0': 'conv1', 'Epilogue)1': 'downsample',
            'Epilogue)2': 'conv2'}


def by_launch(times: dict) -> dict:
    """Device ms by kernel name -> by launch of the block."""
    out = {}
    for name, ms in times.items():
        key = next((v for k, v in LAUNCHES.items() if k in name), name)
        out[key] = out.get(key, 0.0) + ms
    return out


def block_inputs(g, cin: int, cout: int):
    """x, w1, b1, w2, b2, wd, bd of a block at (BATCH, WINDOW), random at
    the model's init scale."""
    dev = torch.device('cuda', 0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=g) * scale

    ds = cin != cout
    x = randn(BATCH, WINDOW, cin)
    w1, w2 = randn(K, cin, cout, scale=(K * cin) ** -0.5), \
        randn(K, cout, cout, scale=(K * cout) ** -0.5)
    b1, b2, bd = (randn(cout, scale=0.1) for _ in range(3))
    wd = randn(cin, cout, scale=cin ** -0.5) if ds else None
    return x, w1, b1, w2, b2, wd, bd if ds else None


def entry_args(x, packed, b1, b2, bd, h, r, out, dilation: int,
               stages: int) -> tuple:
    """The C entry's arguments, as ``ops.tcn.launch_tf32x3`` passes
    them, for a call on tensors that are known to be right."""
    w1, w2, wd = packed
    ds = wd is not None
    b, t, c = x.shape
    return (x.data_ptr(), w1[0].data_ptr(), w1[1].data_ptr(), b1.data_ptr(),
            w2[0].data_ptr(), w2[1].data_ptr(), b2.data_ptr(),
            wd[0].data_ptr() if ds else None, wd[1].data_ptr() if ds else None,
            bd.data_ptr() if ds else None, h.data_ptr(),
            r.data_ptr() if ds else None, out.data_ptr(), b, t, c,
            out.shape[-1], K, dilation, stages,
            torch.cuda.current_stream(x.device).cuda_stream)


def diag(runs: int) -> dict:
    """Device ms of the 12 blocks by launch, per diagnostic build."""
    from fvt_tpu_torch.ops import tcn as tcn_ops
    from fvt_tpu_torch.tools.profile_conv_bf16 import build_variants

    fns = build_variants('tcn_block_tf32x3.cu',
                         'fvt_tcn_block_tf32x3_forward', 13, 7, {
                             'kernel': (),
                             'products_only': ('-DFVT_DIAG_PRODUCTS_ONLY',),
                             'copies_only': ('-DFVT_DIAG_COPIES_ONLY',),
                             'no_split': ('-DFVT_DIAG_NO_SPLIT',)})
    g = torch.Generator(device='cuda').manual_seed(SEED)
    blocks = []
    for _, cin, cout, d in block_shapes():
        x, w1, b1, w2, b2, wd, bd = block_inputs(g, cin, cout)
        packed = tcn_ops.pack_block_weights(w1, w2, wd)
        h, r, out = (torch.empty((BATCH, WINDOW, cout), device=x.device)
                     for _ in range(3))
        blocks.append(entry_args(tcn_ops.pad_channels(x), packed, b1, b2,
                                 bd, h, r, out, d, tcn_ops.ALL))
    result = {}
    for name, fn in fns.items():
        def launch(args, fn=fn, name=name):
            err = fn(*args)
            if err:
                raise RuntimeError(f'{name} build: CUDA error {err}')

        passes = [lambda a=a, launch=launch: launch(a) for a in blocks]
        result[name] = by_launch(device_ms(passes, runs))
        print(f'{name}: device ms of the 12 blocks '
              f'{sum(result[name].values()):.4f}; by launch '
              + ', '.join(f'{k} {v:.4f}' for k, v in result[name].items()),
              flush=True)
    return result


def serve(runs: int) -> dict:
    """Median host ms of a full dispatch, by backbone type and TCN
    kernel, timed in turns."""
    import numpy as np

    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.ops import tcn as tcn_ops
    from fvt_tpu_torch.serve import ServingModel

    kernel = tcn_ops.fused_temporal_block

    def simt(*args, packed=None, **kw):
        return tcn_ops.fused_temporal_block_simt(*args, **kw)

    dev = torch.device('cuda', 0)
    model = LFAN(MODALITY, output_dim=7,
                 generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    result = {}
    for name, kw in (('fp32', {}), ('bf16', {'backbone_dtype':
                                             torch.bfloat16})):
        variant = LFAN(MODALITY, output_dim=7, conv_impl='shifted_kernel',
                       **kw)
        variant.load_state_dict(model.state_dict(), strict=True)
        server = ServingModel(variant, BATCH, WINDOW, 200, dev)
        inputs = {k: (rng.integers(0, 256, v['shape'], np.uint8)
                      if v['dtype'] == 'uint8'
                      else rng.standard_normal(v['shape'], np.float32))
                  for k, v in server.specs.items()}
        times = {'kernel': [], 'simt': []}
        try:
            for tcn in ('kernel', 'simt', 'simt', 'kernel'):
                tcn_ops.fused_temporal_block = kernel if tcn == 'kernel' \
                    else simt
                for _ in range(3):
                    server.call(inputs)
                for _ in range(runs):
                    t0 = time.perf_counter()
                    server.call(inputs)
                    times[tcn].append((time.perf_counter() - t0) * 1e3)
        finally:
            tcn_ops.fused_temporal_block = kernel
        result[name] = {k: statistics.median(v) for k, v in times.items()}
        print(f'{name} shifted_kernel dispatch, median of {2 * runs} in '
              f'turns: TCN on the split-TF32 kernel '
              f'{result[name]["kernel"]:.2f} ms, on the SIMT kernel '
              f'{result[name]["simt"]:.2f} ms', flush=True)
    return result


def host_us(fn, runs: int) -> float:
    """Host us a call of ``fn``, back to back as the model path makes them
    (the card's queue absorbs what they launch), after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    us = (time.perf_counter() - t0) / runs * 1e6
    torch.cuda.synchronize()
    return us


def encode_us(runs: int) -> float:
    """Host us of one ``cuTensorMapEncodeTiled`` of the kind each launch
    encodes (x of (8, 300, 256) fp32, boxes of 4 channels x 80 rows),
    called through ctypes as the kernel's host code calls it."""
    x = torch.empty((BATCH, WINDOW, 256), device='cuda')
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    dims = (u64 * 3)(256, WINDOW, BATCH)
    strides = (u64 * 2)(256 * 4, WINDOW * 256 * 4)
    box, ones = (u32 * 3)(4, 80, 1), (u32 * 3)(1, 1, 1)
    buf = ctypes.create_string_buffer(256)  # a CUtensorMap is 128 bytes,
    addr = (ctypes.addressof(buf) + 63) // 64 * 64  # 64-byte aligned
    encode = ctypes.CDLL('libcuda.so.1').cuTensorMapEncodeTiled
    # FLOAT32 = 7, rank 3, no interleave or swizzle, L2 promotion 128B = 2
    args = (ctypes.c_void_p(addr), 7, 3, ctypes.c_void_p(x.data_ptr()),
            dims, strides, box, ones, 0, 0, 2, 0)
    if encode(*args):
        raise RuntimeError('cuTensorMapEncodeTiled refused the map')
    return host_us(lambda: encode(*args), runs)


def profile_block(g, cin: int, cout: int, d: int, runs: int) -> tuple:
    """The block's row of measurements, and for the split-TF32 and the
    SIMT kernel a callable that launches the whole block."""
    from fvt_tpu_torch.kernels import build
    from fvt_tpu_torch.ops import tcn as tcn_ops

    dev = torch.device('cuda', 0)
    ds = cin != cout
    x, w1, b1, w2, b2, wd, bd = args = block_inputs(g, cin, cout)
    kw = dict(kernel_size=K, dilation=d)
    want = tcn_ops.fused_temporal_block_ref(*args, **kw)
    h, r, out = (torch.empty(want.shape, device=dev) for _ in range(3))
    xp = tcn_ops.pad_channels(x)
    packed = tcn_ops.pack_block_weights(w1, w2, wd)
    stages = {'conv1': tcn_ops.CONV1, 'conv2': tcn_ops.CONV2}
    if ds:
        stages['downsample'] = tcn_ops.DOWNSAMPLE

    def run(stage=tcn_ops.ALL):
        tcn_ops.launch_tf32x3(xp, packed, b1, b2, bd, h, r, out,
                              stages=stage, **kw)

    run()
    torch.cuda.synchronize()
    passes = {'kernel': run}
    row = {'max_abs_err': (out - want).abs().max().item(),
           'ms': median_ms(run, runs),
           'launch_ms': {key: median_ms(lambda: run(s), runs)
                         for key, s in stages.items()},
           'device_ms': by_launch(device_ms([run], runs))}
    # host time of a call: the wrapper on kept packed weights, as the
    # model path calls it; launch_tf32x3 on ready workspaces; the C entry
    # alone
    entry = build.library().fvt_tcn_block_tf32x3_forward
    c_args = entry_args(xp, packed, b1, b2, bd, h, r, out, d, tcn_ops.ALL)
    host = {'call': host_us(lambda: tcn_ops.fused_temporal_block(
                *args, **kw, packed=packed), runs * 10),
            'launch_tf32x3': host_us(run, runs * 10),
            'c_entry': host_us(lambda: entry(*c_args), runs * 10)}
    row['host_us'] = {'wrapper': host['call'] - host['launch_tf32x3'],
                      'checks': host['launch_tf32x3'] - host['c_entry'],
                      **host}
    passes['simt'] = lambda: tcn_ops.fused_temporal_block_simt(*args, **kw)
    row['simt_ms'] = median_ms(passes['simt'], runs)
    row['plain_ms'] = median_ms(
        lambda: tcn_ops.fused_temporal_block_ref(*args, **kw), runs)
    return row, passes


def host_floor(runs: int) -> dict:
    """Host us of the pieces a call is made of, measured alone."""
    from fvt_tpu_torch.kernels import build

    entry = build.library().fvt_tcn_block_tf32x3_forward
    stream = torch.cuda.current_stream().cuda_stream
    shape = (BATCH, WINDOW, 256)
    return {'encode': encode_us(runs),
            'empty': host_us(lambda: torch.empty(shape, device='cuda'),
                             runs),
            # B = 0: refused before any encode or launch
            'refused_c_entry': host_us(lambda: entry(
                *([None] * 13), 0, 1, 8, 8, K, 1, 7, stream), runs)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--runs', type=int, default=20)
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument('--diag', action='store_true')
    mode.add_argument('--serve', action='store_true')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_tcn: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True,
        text=True).stdout.strip()
    print(card)
    if args.diag:
        with torch.inference_mode():
            print(json.dumps({'card': card, 'diag': diag(args.runs)}))
        return 0
    if args.serve:
        print(json.dumps({'card': card, 'serve': serve(args.runs)}))
        return 0
    g = torch.Generator(device='cuda').manual_seed(SEED)
    blocks, total, passes = [], {}, {'kernel': [], 'simt': []}
    with torch.inference_mode():
        for name, cin, cout, d in block_shapes():
            row, fns = profile_block(g, cin, cout, d, args.runs)
            for key, fn in fns.items():
                passes[key].append(fn)
            print(f'{name} ({BATCH},{WINDOW},{cin})->{cout} d={d}: '
                  f'{row["ms"]:.4f} ms (err {row["max_abs_err"]:.2e}; '
                  + ', '.join(f'{k} {ms:.4f}'
                              for k, ms in row['launch_ms'].items())
                  + f'); simt {row["simt_ms"]:.4f}; plain '
                  f'{row["plain_ms"]:.4f}; device ' + ', '.join(
                      f'{k} {v:.4f}' for k, v in row['device_ms'].items())
                  + '; host us a call ' + ', '.join(
                      f'{k} {v:.1f}' for k, v in row['host_us'].items()),
                  flush=True)
            blocks.append({'block': name, 'cin': cin, 'cout': cout,
                           'dilation': d, **row})
            for key in ('ms', 'simt_ms', 'plain_ms'):
                total[key] = total.get(key, 0.0) + row[key]
            for key, us in row['host_us'].items():
                total[f'host_us_{key}'] = total.get(f'host_us_{key}', 0.0) + us
        for key, fns in passes.items():
            by_kernel = device_ms(fns, args.runs)
            total[f'device_{key}'] = sum(by_kernel.values())
            print(f'device time of the 12 blocks, {key}: '
                  f'{total[f"device_{key}"]:.4f} ms; by kernel: '
                  + '; '.join(f'{k} {v:.4f}' for k, v in by_kernel.items()))
        floor = host_floor(args.runs * 50)
    print('host us alone: ' + ', '.join(f'{k} {v:.2f}'
                                         for k, v in floor.items()))
    print(json.dumps({'card': card, 'blocks': blocks, 'total_ms': total,
                      'host_floor_us': floor}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
