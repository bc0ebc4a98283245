"""Face-image compaction CLI: cropped jpgs -> per-trial video.npy; a copy
of ``fvt_tpu/preprocess/compact.py`` (host code), held equal to it by
``tests/test_torch_copies.py``.

The upstream's dlib/compact_face_images.py:93-298: gather the top face
jpg per frame into a (n, 256, 256, 3) uint8 array, reconcile the other
modality arrays' frame counts (truncate longer, assert equal otherwise),
block-sharded over trials.

Usage:
  python -m fvt_tpu_torch.preprocess.compact --faces_root <cropped_aligned> \
      --features_root <.../features/compacted_48> --split train \
      [--nblocks N --process_block i]
"""
from __future__ import annotations

import argparse
import os
import re
from os.path import join
from typing import List

import numpy as np

from fvt_tpu_torch import constants
from fvt_tpu_torch.preprocess.faces import compact_video_npy, OUT_SIZE
from fvt_tpu_torch.preprocess.sharding import better_chunks_into_n
from fvt_tpu_torch.utils.logger import log


def load_top_faces(face_dir: str, size: int = OUT_SIZE) -> np.ndarray:
    """frame-<i>/face-0.jpg per frame -> (n, size, size, 3) uint8
    (compact_face_images.py:93-132); missing frames stay zeros."""
    from PIL import Image

    frame_dirs = [d for d in os.listdir(face_dir)
                  if re.match(r'frame-\d+$', d)]
    if not frame_dirs:
        return np.zeros((0, size, size, 3), np.uint8)
    n = max(int(d.split('-')[1]) for d in frame_dirs) + 1
    out = np.zeros((n, size, size, 3), np.uint8)
    for d in frame_dirs:
        i = int(d.split('-')[1])
        path = join(face_dir, d, 'face-0.jpg')
        if os.path.isfile(path):
            img = Image.open(path).convert('RGB')
            if img.size != (size, size):
                img = img.resize((size, size))
            out[i] = np.asarray(img, dtype=np.uint8)
    return out


def compact_trial(faces_root: str, features_root: str, trial: str,
                  strict: bool = False):
    face_dir = join(faces_root, trial)
    trial_dir = join(features_root, trial)
    assert os.path.isdir(face_dir), face_dir
    assert os.path.isdir(trial_dir), trial_dir
    if os.path.isfile(join(trial_dir, 'video.npy')):
        return
    faces = load_top_faces(face_dir)
    compact_video_npy(trial_dir, faces, strict=strict)


def main(argv=None):
    p = argparse.ArgumentParser(description='face compaction')
    p.add_argument('--faces_root', required=True)
    p.add_argument('--features_root', required=True)
    p.add_argument('--split', default=None,
                   help='subdir of trials to process (e.g. train)')
    p.add_argument('--nblocks', type=int, default=1)
    p.add_argument('--process_block', type=int, default=0)
    p.add_argument('--ds', default=constants.MELD,
                   help='dataset name; MELD hard-asserts feature/frame '
                        'length agreement like the reference '
                        '(compact_face_images.py:248), C-EXPR-DB* '
                        'reconciles by truncation')
    args = p.parse_args(argv)

    root = join(args.faces_root, args.split) if args.split \
        else args.faces_root
    prefix = f'{args.split}/' if args.split else ''
    trials: List[str] = sorted(
        prefix + d for d in os.listdir(root)
        if os.path.isdir(join(root, d)))
    block = better_chunks_into_n(trials, args.nblocks)[args.process_block]
    log(f"compacting block {args.process_block}/{args.nblocks}: "
        f"{len(block)} of {len(trials)} trials")
    strict = args.ds == constants.MELD
    for trial in block:
        compact_trial(args.faces_root, args.features_root, trial,
                      strict=strict)


if __name__ == '__main__':
    main()
