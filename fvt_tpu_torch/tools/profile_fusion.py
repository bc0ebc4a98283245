"""The split-TF32 fusion kernel (B2) on the card, by diagnostic build.

    python3 -m fvt_tpu_torch.tools.profile_fusion [--iters 50]

Builds ``csrc/fusion_tf32x3.cu`` once a switch, all at once: as it is,
``-DFVT_DIAG_PRODUCTS_ONLY`` (no copy started or waited for: the
consumers' work on whatever shared memory holds), ``-DFVT_DIAG_NO_PRODUCTS``
(no ``wgmma``), ``-DFVT_DIAG_NO_SPLIT`` (x left as it landed) and
``-DFVT_DIAG_CLOCK`` (right sums; block 0's first tile reads ``clock64``
at the end of each phase).  The diagnostic builds but the last give
wrong sums.  Each build's launch
alone is timed on the same inputs, random weights at Linear's init scale,
at the main path's (8, 300) frames of 128, 32 and 128 channels (E = 32,
H = 2) and at all seven modalities: the median of ``--iters`` launches
between CUDA events and the device time a launch from ``torch.profiler``;
for the clock build, also the cycles each phase of a tile took: per head
(and slice) its qkv products then its attention, then o's products and
the LayerNorm.  Prints the card, ptxas's registers and its notes on
``wgmma``, and one JSON line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

VARIANTS = {'kernel': (), 'products_only': ('-DFVT_DIAG_PRODUCTS_ONLY',),
            'no_products': ('-DFVT_DIAG_NO_PRODUCTS',),
            'no_split': ('-DFVT_DIAG_NO_SPLIT',),
            'clock': ('-DFVT_DIAG_CLOCK',)}
CASES = {'M=3': ('video', 'vggish', 'bert'),
         'M=7': ('video', 'bert', 'cnn_res50', 'mfcc', 'vggish', 'logmel',
                 'egemaps')}
FRAMES = (8, 300)
MODAL_DIM, HEADS = 32, 2


def launch_args(mods, device, g) -> tuple:
    """The C entry's arguments before the stream, on random inputs."""
    from fvt_tpu_torch.config import model_config as MC
    from fvt_tpu_torch.ops import fusion as fusion_ops

    widths = [MC.ENCODER_DIM[m] for m in mods]
    e, m = MODAL_DIM, len(mods)
    em = e * m

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=device, generator=g) * scale

    xs = [randn(*FRAMES, c) for c in widths]
    wqkv = [randn(c, 3 * e, scale=c ** -0.5) for c in widths]
    bqkv = [randn(3 * e, scale=0.1) for _ in widths]
    wo = randn(em, em, scale=em ** -0.5)
    vecs = [randn(em, scale=0.1), 1.0 + randn(em, scale=0.2),
            randn(em, scale=0.1)]
    packed = fusion_ops.pack_fusion_weights(wqkv, bqkv, wo, modal_dim=e,
                                            num_heads=HEADS)
    out = torch.empty(*FRAMES, em, device=device)
    keep = (xs, packed, vecs, out)  # alive while the pointers are used
    ptrs = (ctypes.c_void_p * (4 * m))(
        *(x.data_ptr() for x in xs),
        *(p[0].data_ptr() for p in packed['wqkv']),
        *(p[1].data_ptr() for p in packed['wqkv']),
        *(b.data_ptr() for b in packed['bqkv']))
    args = (ptrs, (ctypes.c_int * m)(*widths), packed['wo'][0].data_ptr(),
            packed['wo'][1].data_ptr(), *(v.data_ptr() for v in vecs),
            out.data_ptr(), None, 0, FRAMES[0] * FRAMES[1], m, e, HEADS)
    return args, keep


def phases(fn, cargs: tuple, stream) -> list:
    """The clock build's phases of block 0's first tile, in cycles, from
    one more launch: [qkv products, attention] per head (and slice), then
    o's products and the LayerNorm."""
    from fvt_tpu_torch.kernels import build

    fn(*cargs, stream)  # the build's entry, bound by build_variants
    torch.cuda.synchronize()
    lib = ctypes.CDLL(str(build.BUILD_DIR / 'fusion_tf32x3-clock.so'))
    lib.fvt_fusion_tf32x3_marks.argtypes = [ctypes.c_void_p]
    marks = (ctypes.c_longlong * 64)()
    lib.fvt_fusion_tf32x3_marks(marks)
    # marks: each slice's start and products, the last attention's end,
    # o's products, the LayerNorm (a tile's start is 0)
    ends = [0] + [v for v in marks[1:] if v > 0]
    return [b - a for a, b in zip(ends, ends[1:])]


def main(argv=None) -> int:
    from fvt_tpu_torch.tools.profile_conv_bf16 import (build_variants,
                                                       median_ms)
    from fvt_tpu_torch.tools.timing import device_ms

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--iters', type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_fusion: no CUDA device', file=sys.stderr)
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    fns = build_variants('fusion_tf32x3.cu', 'fvt_fusion_tf32x3_forward', 8,
                         4, VARIANTS)
    device = torch.device('cuda', 0)
    g = torch.Generator(device=device).manual_seed(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    result = {'card': card}
    for case, mods in CASES.items():
        cargs, keep = launch_args(mods, device, g)
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(*cargs, stream)
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')
            ms = median_ms(call, args.iters)
            dev = device_ms(call, ('fusion_tf32x3_kernel',), args.iters)
            result[f'{case} {name}'] = {'ms': ms, 'device_ms': dev}
            print(f'  {case} {name}: {ms:.4f} ms a launch, device {dev}',
                  flush=True)
            if name == 'clock':
                result[f'{case} phases'] = phases(fn, cargs, stream)
                print(f'  {case} cycles by phase: {result[f"{case} phases"]}')
        del keep
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
