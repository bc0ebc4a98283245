"""Dataset creation: video trimming, stratified k-fold splits, fold
dumps; a copy of ``fvt_tpu/preprocess/splits.py``, ``class_id.yaml``
written by ``config/flat_yaml`` (no PyYAML), held equal to it by
``tests/test_torch_copies.py``.

The upstream's dlib/c_expr_db.py:540-800: annotation-driven ffmpeg
trimming, per-class round-robin k-fold creation, and fold-file dumping in
the ``<video_id>,<label_int>,<transcript>`` format + ``class_id.yaml``
contract the training stack consumes.
"""
from __future__ import annotations

import copy
import os
import shutil
import subprocess
from collections import defaultdict
from os.path import basename, join
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import flat_yaml
from fvt_tpu_torch.utils import rng as rng_mod
from fvt_tpu_torch.utils.logger import log

# dlib/datasets/default_labels_order.py:13-42 — compound emotions
COMPOUND_LABEL_ORDER = {
    constants.FEARFULLY_SURPRISED: 0,
    constants.HAPPILY_SURPRISED: 1,
    constants.SADLY_SURPRISED: 2,
    constants.DISGUSTEDLY_SURPRISED: 3,
    constants.ANGRILY_SURPRISED: 4,
    constants.SADLY_FEARFUL: 5,
    constants.SADLY_ANGRY: 6,
}

BASIC_LABEL_ORDER = {
    constants.SURPRISE: 0,
    constants.FEAR: 1,
    constants.DISGUST: 2,
    constants.SADNESS: 3,
    constants.HAPPINESS: 4,
    constants.ANGER: 5,
    constants.NEUTRAL: 6,
}


def trim_video(video_path: str, start: str, end: str, dest_video: str):
    """ffmpeg stream-copy trim (c_expr_db.py:540-570)."""
    assert shutil.which('ffmpeg'), 'ffmpeg not available'
    os.makedirs(os.path.dirname(os.path.abspath(dest_video)), exist_ok=True)
    subprocess.run(
        ['ffmpeg', '-y', '-loglevel', 'error', '-ss', str(start), '-to',
         str(end), '-i', video_path, '-c:v', 'copy', '-c:a', 'copy',
         dest_video],
        check=True)


def create_folds(clips_per_class: Dict[str, List[str]], n: int,
                 seed: int = 0) -> List[List[str]]:
    """Per-class shuffled round-robin distribution into n folds
    (stratified: each fold gets ~1/n of every class)."""
    rng = rng_mod.np_rng(seed, 'create_folds')
    folds: List[List[str]] = [[] for _ in range(n)]
    for cl in sorted(clips_per_class):
        clips = sorted(clips_per_class[cl])
        rng.shuffle(clips)
        for i, clip in enumerate(clips):
            folds[i % n].append(clip)
    return folds


def kfold_splits(clips_per_class: Dict[str, List[str]], n: int = 5,
                 seed: int = 0) -> Dict[int, Dict[str, List[str]]]:
    """n cross-validation splits: fold i is valid, the rest train
    (c_expr_db.py:732-771)."""
    folds = create_folds(clips_per_class, n, seed)
    splits = {}
    for i in range(n):
        train: List[str] = []
        for j in range(n):
            if j != i:
                train.extend(folds[j])
        splits[i] = {constants.TRAINSET: copy.deepcopy(train),
                     constants.VALIDSET: copy.deepcopy(folds[i])}
        for e in train:
            assert e not in folds[i], e
    return splits


def dump_fold_files(splits: Dict[int, Dict[str, List[str]]],
                    labels: Dict[str, int],
                    class_id: Dict[str, int],
                    folds_dir: str,
                    transcripts: Optional[Dict[str, str]] = None,
                    test_equals_valid: bool = True):
    """Write folds/<split-k>/{train,val,test}.txt + class_id.yaml."""
    transcripts = transcripts or {}
    for k, split in splits.items():
        d = join(folds_dir, f'split-{k}')
        os.makedirs(d, exist_ok=True)
        flat_yaml.dump(class_id, join(d, 'class_id.yaml'))

        per_split = dict(split)
        if test_equals_valid and constants.TESTSET not in per_split:
            per_split[constants.TESTSET] = split[constants.VALIDSET]

        for split_name, clips in per_split.items():
            with open(join(d, f'{split_name}.txt'), 'w') as f:
                for clip in clips:
                    txt = transcripts.get(clip, '')
                    f.write(f'{clip},{labels[clip]},{txt}\n')
    log(f"dumped {len(splits)} fold splits to {folds_dir}")


def main(argv=None):
    """CLI: build stratified k-fold fold files from a labels csv.

    csv columns: video,label_int[,transcript]
    """
    import argparse
    import csv as csv_mod

    p = argparse.ArgumentParser(description='k-fold split creation')
    p.add_argument('--labels_csv', required=True)
    p.add_argument('--folds_dir', required=True)
    p.add_argument('--num_folds', type=int, default=5)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--label_order', choices=['compound', 'basic'],
                   default='compound')
    p.add_argument('--include_other', action='store_true')
    args = p.parse_args(argv)

    clips_per_class: Dict[str, List[str]] = defaultdict(list)
    labels: Dict[str, int] = {}
    transcripts: Dict[str, str] = {}
    with open(args.labels_csv) as f:
        for row in csv_mod.reader(f):
            if not row or row[0] == 'video':
                continue
            vid, cl = row[0], int(row[1])
            labels[vid] = cl
            clips_per_class[str(cl)].append(vid)
            if len(row) > 2:
                transcripts[vid] = ','.join(row[2:])

    class_id = dict(COMPOUND_LABEL_ORDER if args.label_order == 'compound'
                    else BASIC_LABEL_ORDER)
    # ALWAYS present, like the reference (c_expr_db.py:780-782 writes
    # full_labels[OTHER] = 7 unconditionally): the DataArranger requires
    # the 'Other' key even when use_other_class is False (it filters BY
    # looking the id up), so omitting it crashed C-EXPR-DB training on
    # repo-generated folds.  --include_other remains accepted (no-op).
    class_id[constants.OTHER] = 7

    splits = kfold_splits(clips_per_class, n=args.num_folds,
                          seed=args.seed)
    dump_fold_files(splits, labels, class_id, args.folds_dir, transcripts)


def simplify_meld_csv(csv_path: str, out_path: str,
                      corrupted: Sequence[str] = ()) -> List[dict]:
    """MELD csv -> simplified rows, with encoding fixes and corrupted-video
    filtering (c_expr_db.py:152-281 simplify_csv)."""
    import csv as csv_mod

    rows = []
    with open(csv_path, 'r', encoding='utf-8', errors='replace') as f:
        reader = csv_mod.DictReader(f)
        for r in reader:
            utt = r.get('Utterance', '')
            # the MELD csv's mojibake fixes (cp1252-mangled utf-8)
            try:
                utt = utt.encode('latin1').decode('utf-8')
            except (UnicodeEncodeError, UnicodeDecodeError):
                pass
            utt = utt.replace('\x92', "'").replace('\x85', '...') \
                .replace('\x97', ' ').replace('\x91', "'") \
                .replace('\x93', '"').replace('\x94', '"').replace('\n', ' ')
            vid = f"dia{r['Dialogue_ID']}_utt{r['Utterance_ID']}"
            if vid in corrupted:
                continue
            rows.append({'video': vid, 'emotion': r['Emotion'],
                         'utterance': utt})

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, 'w', encoding='utf-8') as f:
        w = csv_mod.DictWriter(f, fieldnames=['video', 'emotion',
                                              'utterance'])
        w.writeheader()
        w.writerows(rows)
    return rows


if __name__ == '__main__':
    main()
