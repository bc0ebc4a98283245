"""Re-compact raw video stores to the transform scale (one-time 48^2); a
copy of ``fvt_tpu/preprocess/recompact.py`` (host code) through the
port's ``data/native_store`` and ``data/host_resize``, held equal to it
by ``tests/test_torch_copies.py``.

The disk contract stores 256^2 uint8 faces per trial (the upstream's
configs.py:20 SZ256 — in a directory the upstream itself names
``compacted_48``), but the model consumes 48->40 crops, so every epoch
of training/eval pays a 256->48 resize per frame on the loader host.
This CLI materializes ``video_48.npy`` next to each ``video.npy`` with
the exact antialiased-bilinear kernel (the native band-limited path when
built, the python gemm fallback otherwise — both the SAME values the
on-the-fly loader path produces), after which the loader reads the small
file directly.

Idempotent (existing up-to-date video_48.npy skipped) and shardable
with the same --part/--nparts job-array semantics as the feature driver
(mit.divide block split, preprocess/sharding.py).

Usage:
    python -m fvt_tpu_torch.preprocess.recompact \
        --features_path <root>/features/compacted_48 [--size 48]
        [--part 0 --nparts 8]
"""
from __future__ import annotations

import argparse
import os
from os.path import join
from typing import List, Optional

import numpy as np

from fvt_tpu_torch.data.transforms import SCALE_SIZE
from fvt_tpu_torch.preprocess.sharding import divide


def recompact_trial(trial_dir: str, size: int = SCALE_SIZE,
                    feature: str = 'video') -> Optional[str]:
    """Write <trial_dir>/<feature>_<size>.npy; returns the path written
    or None when skipped (absent source / already current / not a raw
    uint8 4-D store)."""
    src = join(trial_dir, f'{feature}.npy')
    dst = join(trial_dir, f'{feature}_{size}.npy')
    if not os.path.isfile(src):
        return None
    arr = np.load(src, mmap_mode='r')
    if arr.ndim != 4 or arr.dtype != np.uint8 or arr.shape[1] == size:
        return None
    if os.path.isfile(dst):
        prev = np.load(dst, mmap_mode='r')
        if prev.shape == (arr.shape[0], size, size, arr.shape[3]) and \
                os.path.getmtime(dst) >= os.path.getmtime(src):
            return None  # current

    from fvt_tpu_torch.data import native_store
    idx = np.arange(arr.shape[0], dtype=np.int64)
    out = None
    if native_store.ensure_built():
        out = native_store.gather_resize_rows(src, idx, size)
    if out is None:
        from fvt_tpu_torch.data.host_resize import resize_frames_uint8
        out = resize_frames_uint8(np.asarray(arr), size)

    tmp = dst + '.tmp'
    with open(tmp, 'wb') as f:  # file handle: np.save appends no suffix
        np.save(f, out)
    os.replace(tmp, dst)
    return dst


def trial_dirs(features_path: str) -> List[str]:
    out = []
    for root, dirs, files in os.walk(features_path):
        if 'video.npy' in files:
            out.append(root)
    return sorted(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--features_path', required=True,
                    help='root holding per-trial dirs with video.npy')
    ap.add_argument('--size', type=int, default=SCALE_SIZE)
    ap.add_argument('--part', type=int, default=0)
    ap.add_argument('--nparts', type=int, default=1)
    args = ap.parse_args(argv)

    trials = trial_dirs(args.features_path)
    shard = list(divide(args.nparts, trials)[args.part])
    done = skipped = 0
    for td in shard:
        if recompact_trial(td, size=args.size):
            done += 1
        else:
            skipped += 1
    print(f'recompact: {done} written, {skipped} skipped '
          f'(part {args.part}/{args.nparts}, {len(shard)} trials)')


if __name__ == '__main__':
    main()
