"""A synthetic on-disk feature store in the disk contract the loaders read,
written without ``fvt_tpu`` or PyYAML: the port's counterpart of
``tests/synth_store.py``'s ``make_cexpr_store``, for a C-EXPR-DB or
challenge store of chosen video lengths: a challenge store to run
``inference_challenge`` on, or a C-EXPR-DB training store (train and val
splits; test is val) to run ``fvt_tpu_torch.main`` on.

Writes ``features/compacted_48/<split>/vid<i>/{video,vggish,bert,
EXPR_continuous_label}.npy`` (video as 48^2 uint8 face crops, the size a
recompacted store keeps, or with ``--video_hw 256`` at the disk
contract's 256^2, which the loaders resize on the host) and with
``--logmel`` ``logmel.npy``, the raw-audio modality the VGGish takes in
the model: ``(T, 96, 64)`` float16 log-mel patches (``tests/
synth_store.py``'s ``add_logmel_features``; vggish and bert stay, since
the fold's mean/std reads them whatever the modality),
``features/dataset_info_<ds>_<split>.pkl`` with the extractor version
stamp, and ``folds/<ds>/split-0/`` with the split lists and
``class_id.yaml``.  Every array is drawn from ``seed``.

    python -m fvt_tpu_torch.tools.synth_store <root> 60 90 150 ...
    python -m fvt_tpu_torch.tools.synth_store <root> 300 900 1800 \
        --ds C-EXPR-DB --val_lengths 400 1200 [--video_hw 256] [--logmel]
"""
from __future__ import annotations

import argparse
import os
import shutil
from os.path import join
from typing import Sequence

import numpy as np

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import flat_yaml
from fvt_tpu_torch.preprocess.version import stamp
from fvt_tpu_torch.utils.io import save_pickle

COMPOUND_CLASSES = [
    constants.FEARFULLY_SURPRISED, constants.HAPPILY_SURPRISED,
    constants.SADLY_SURPRISED, constants.DISGUSTEDLY_SURPRISED,
    constants.ANGRILY_SURPRISED, constants.SADLY_FEARFUL,
    constants.SADLY_ANGRY, constants.OTHER,
]


def make_cexpr_store(root: str, lengths: Sequence[int],
                     ds: str = constants.C_EXPR_DB_CHALLENGE,
                     val_lengths: Sequence[int] = (), seed: int = 0,
                     video_hw: int = 48, separation: float = 3.0,
                     logmel: bool = False) -> dict:
    """One video a length of ``lengths`` in the train split (the challenge
    store's only split) and of ``val_lengths`` in C-EXPR-DB's val split.
    Each video has one label of the 8 compound classes; its features are
    that class's center plus unit noise.  Returns the ``dataset_path`` and
    ``folds_dir`` to pass to the CLIs."""
    assert ds in (constants.C_EXPR_DB, constants.C_EXPR_DB_CHALLENGE), ds
    rng = np.random.default_rng(seed)
    ncls = len(COMPOUND_CLASSES)
    feat_dir = join(root, 'features', 'compacted_48')
    folds_dir = join(root, 'folds', ds, 'split-0')
    os.makedirs(folds_dir, exist_ok=True)
    centers = {m: rng.normal(size=(ncls, dim)) * separation
               for m, dim in ((constants.VGGISH, 128), (constants.BERT, 768))}

    splits = {constants.TRAINSET: lengths}
    if ds == constants.C_EXPR_DB:
        splits[constants.VALIDSET] = val_lengths
    for split, lens in splits.items():
        trials, lines = [], []
        for i, length in enumerate(lens):
            trial = f'{split}/vid{i}'
            label = int(rng.integers(0, ncls))
            tdir = join(feat_dir, trial)
            os.makedirs(tdir, exist_ok=True)
            np.save(join(tdir, 'video.npy'), rng.integers(
                0, 256, (length, video_hw, video_hw, 3), dtype=np.uint8))
            for m, c in centers.items():
                feats = c[label] + rng.normal(size=(length, c.shape[1]))
                np.save(join(tdir, f'{m}.npy'), feats.astype(np.float32))
            np.save(join(tdir, f'{constants.EXPR}.npy'),
                    np.full((length,), label, dtype=np.int64))
            if logmel:
                np.save(join(tdir, f'{constants.LOGMEL}.npy'),
                        rng.standard_normal((length, 96, 64), np.float32)
                        .astype(np.float16))
            trials.append(trial)
            lines.append(f'{trial},{label},compound transcript {i}')
        save_pickle(stamp({'data_folder': 'compacted_48', 'trial': trials,
                           'length': [int(n) for n in lens],
                           'partition': split}),
                    join(root, 'features', f'dataset_info_{ds}_{split}.pkl'))
        with open(join(folds_dir, f'{split}.txt'), 'w') as f:
            f.write('\n'.join(lines) + '\n')

    # C-EXPR-DB: test.txt is val.txt; the challenge: every split is train
    copies = ({constants.TESTSET: constants.VALIDSET}
              if ds == constants.C_EXPR_DB else
              {constants.VALIDSET: constants.TRAINSET,
               constants.TESTSET: constants.TRAINSET})
    for dst, src in copies.items():
        shutil.copy(join(folds_dir, f'{src}.txt'),
                    join(folds_dir, f'{dst}.txt'))
    flat_yaml.dump({c: i for i, c in enumerate(COMPOUND_CLASSES)},
                   join(folds_dir, 'class_id.yaml'))
    return {'dataset_path': root, 'folds_dir': join(root, 'folds', ds)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('root')
    p.add_argument('lengths', type=int, nargs='+',
                   help='train split video lengths (the challenge store\'s '
                        'only split)')
    p.add_argument('--ds', default=constants.C_EXPR_DB_CHALLENGE,
                   choices=(constants.C_EXPR_DB,
                            constants.C_EXPR_DB_CHALLENGE))
    p.add_argument('--val_lengths', type=int, nargs='*', default=(),
                   help='C-EXPR-DB\'s val split video lengths')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--video_hw', type=int, default=48, choices=(48, 256),
                   help='the face crops\' side: 48 (a recompacted store) '
                        'or 256 (the disk contract, resized on the host)')
    p.add_argument('--logmel', action='store_true',
                   help='also write logmel.npy, (T, 96, 64) float16')
    args = p.parse_args(argv)
    if (args.ds == constants.C_EXPR_DB) != bool(args.val_lengths):
        p.error('--val_lengths goes with --ds C-EXPR-DB, and it needs them')
    print(make_cexpr_store(args.root, args.lengths, ds=args.ds,
                           val_lengths=args.val_lengths, seed=args.seed,
                           video_hw=args.video_hw, logmel=args.logmel))


if __name__ == '__main__':
    main()
