"""A synthetic on-disk feature store in the disk contract the loaders read,
written without ``fvt_tpu`` or PyYAML: the port's counterpart of
``tests/synth_store.py``.  ``make_cexpr_store`` writes a C-EXPR-DB or
challenge store of chosen video lengths (a challenge store to run
``inference_challenge`` on, or a C-EXPR-DB training store, train and val
splits, test being val, to run ``fvt_tpu_torch.main`` on), or of drawn
lengths with the hardness knobs and k-fold splits, as
``tests/synth_store.py``'s does, draw for draw; ``make_meld_store`` that
file's MELD store (``quickstart``, ``cv_campaign``).

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
from typing import Optional, Sequence

import numpy as np

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import flat_yaml
from fvt_tpu_torch.preprocess.version import stamp
from fvt_tpu_torch.utils.io import save_pickle

CLASSES = [constants.SURPRISE, constants.FEAR, constants.DISGUST,
           constants.SADNESS, constants.HAPPINESS, constants.ANGER,
           constants.NEUTRAL]

COMPOUND_CLASSES = [
    constants.FEARFULLY_SURPRISED, constants.HAPPILY_SURPRISED,
    constants.SADLY_SURPRISED, constants.DISGUSTEDLY_SURPRISED,
    constants.ANGRILY_SURPRISED, constants.SADLY_FEARFUL,
    constants.SADLY_ANGRY, constants.OTHER,
]


def _video_hardness(rng: np.random.Generator, label: int, ncls: int,
                    ambiguity: float, label_noise: float) -> tuple:
    """One draw per video of (ambiguity partner or None, observed label):
    with probability ``ambiguity`` a partner class whose center every
    modality's features blend with half and half, and with probability
    ``label_noise`` a wrong recorded label, uniform over the other
    classes, while the features stay the true class's.  Nothing is drawn
    where a knob is 0."""
    partner = None
    if ambiguity > 0 and rng.random() < ambiguity:
        partner = int((label + 1 + rng.integers(0, ncls - 1)) % ncls)
    obs = label
    if label_noise > 0 and rng.random() < label_noise:
        obs = int((label + 1 + rng.integers(0, ncls - 1)) % ncls)
    return partner, obs


def _class_center(centers: np.ndarray, label: int, partner) -> np.ndarray:
    if partner is not None:
        return 0.5 * (centers[label] + centers[partner])
    return centers[label]


def _write_split(root: str, ds: str, split: str, trials: list,
                 lengths: list, lines: list) -> None:
    save_pickle(stamp({'data_folder': 'compacted_48', 'trial': trials,
                       'length': [int(n) for n in lengths],
                       'partition': split}),
                join(root, 'features', f'dataset_info_{ds}_{split}.pkl'))
    with open(join(root, 'folds', ds, 'split-0', f'{split}.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')


def _write_cv_folds(root: str, ds: str, splits, n_folds: int,
                    seed: int) -> None:
    """C-EXPR-DB's k-fold layout: split-k re-partitions the pool of every
    split's trials (``seed + 1`` draws the order), val and test being the
    k-th chunk."""
    folds_dir = join(root, 'folds', ds)
    pool = []
    for split in splits:
        with open(join(folds_dir, 'split-0', f'{split}.txt')) as f:
            pool += [ln for ln in f.read().splitlines() if ln]
    order = np.random.default_rng(seed + 1).permutation(len(pool))
    for k, chunk in enumerate(np.array_split(order, n_folds)):
        fd = join(folds_dir, f'split-{k}')
        os.makedirs(fd, exist_ok=True)
        val_idx = set(chunk.tolist())
        val = [pool[i] for i in sorted(val_idx)]
        train = [pool[i] for i in range(len(pool)) if i not in val_idx]
        for name, lines in (('train', train), ('val', val), ('test', val)):
            with open(join(fd, f'{name}.txt'), 'w') as f:
                f.write('\n'.join(lines) + '\n')
        flat_yaml.dump({c: i for i, c in enumerate(COMPOUND_CLASSES)},
                       join(fd, 'class_id.yaml'))


def make_cexpr_store(root: str, lengths: Optional[Sequence[int]] = None,
                     ds: str = constants.C_EXPR_DB_CHALLENGE,
                     val_lengths: Sequence[int] = (), seed: int = 0,
                     video_hw: int = 48, separation: float = 3.0,
                     logmel: bool = False, *, n_train: int = 10,
                     n_val: int = 5, min_len: int = 8, max_len: int = 40,
                     label_noise: float = 0.0, ambiguity: float = 0.0,
                     n_folds: int = 1) -> dict:
    """One video a length of ``lengths`` in the train split (the challenge
    store's only split) and of ``val_lengths`` in C-EXPR-DB's val split;
    or, with ``lengths`` None, ``n_train`` (and ``n_val``) videos whose
    lengths are drawn in ``[min_len, max_len]``: then the store is
    ``tests/synth_store.py``'s ``make_cexpr_store`` of the same arguments,
    draw for draw (a store of given lengths keeps its own draws).  Each
    video has one label of the 8 compound classes; its features are that
    class's center (``separation`` apart) plus unit noise.  The hardness
    knobs: ``ambiguity`` and ``label_noise`` (:func:`_video_hardness`),
    and ``n_folds`` > 1 (C-EXPR-DB only) for the k-fold splits.  Returns
    the ``dataset_path`` and ``folds_dir`` to pass to the CLIs."""
    assert ds in (constants.C_EXPR_DB, constants.C_EXPR_DB_CHALLENGE), ds
    assert n_folds == 1 or ds == constants.C_EXPR_DB, (
        f'n_folds > 1 is the C-EXPR-DB CV layout, not {ds}\'s')
    rng = np.random.default_rng(seed)
    ncls = len(COMPOUND_CLASSES)
    feat_dir = join(root, 'features', 'compacted_48')
    folds_dir = join(root, 'folds', ds, 'split-0')
    os.makedirs(folds_dir, exist_ok=True)
    centers = {m: rng.normal(size=(ncls, dim)) * separation
               for m, dim in ((constants.VGGISH, 128), (constants.BERT, 768))}

    drawn = lengths is None
    splits = {constants.TRAINSET: n_train if drawn else lengths}
    if ds == constants.C_EXPR_DB:
        splits[constants.VALIDSET] = n_val if drawn else val_lengths
    for split, lens in splits.items():
        trials, lengths_out, lines = [], [], []
        for i in range(lens if drawn else len(lens)):
            trial = f'{split}/vid{i}'
            label = int(rng.integers(0, ncls))
            length = (int(rng.integers(min_len, max_len + 1)) if drawn
                      else int(lens[i]))
            partner, obs = _video_hardness(rng, label, ncls, ambiguity,
                                           label_noise)
            tdir = join(feat_dir, trial)
            os.makedirs(tdir, exist_ok=True)
            shape = (length, video_hw, video_hw, 3)
            video = (rng.integers(0, 255, size=shape).astype(np.uint8)
                     if drawn else rng.integers(0, 256, shape, dtype=np.uint8))
            np.save(join(tdir, 'video.npy'), video)
            for m, c in centers.items():
                feats = _class_center(c, label, partner) + rng.normal(
                    size=(length, c.shape[1]))
                np.save(join(tdir, f'{m}.npy'), feats.astype(np.float32))
            np.save(join(tdir, f'{constants.EXPR}.npy'),
                    np.full((length,), obs, dtype=np.int64))
            if logmel:
                np.save(join(tdir, f'{constants.LOGMEL}.npy'),
                        rng.standard_normal((length, 96, 64), np.float32)
                        .astype(np.float16))
            trials.append(trial)
            lengths_out.append(length)
            lines.append(f'{trial},{obs},compound transcript {i}')
        _write_split(root, ds, split, trials, lengths_out, lines)

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
    if n_folds > 1:
        _write_cv_folds(root, ds, splits, n_folds, seed)
    return {'dataset_path': root, 'folds_dir': join(root, 'folds', ds)}


def make_meld_store(root: str, n_train: int = 12, n_val: int = 6,
                    n_test: int = 6, min_len: int = 8, max_len: int = 40,
                    ncls: int = 7, seed: int = 0, separation: float = 3.0,
                    with_video: bool = False, label_noise: float = 0.0,
                    ambiguity: float = 0.0) -> dict:
    """A MELD store of vggish and bert streams whose classes are
    ``separation`` apart (learnable in a few epochs), with train, val and
    test splits of drawn lengths, and 64^2 video with ``with_video``:
    ``tests/synth_store.py``'s ``make_meld_store`` of the same arguments,
    draw for draw.  ``label_noise`` / ``ambiguity`` > 0 make it
    non-separable (:func:`_video_hardness`)."""
    rng = np.random.default_rng(seed)
    ds = constants.MELD
    feat_dir = join(root, 'features', 'compacted_48')
    folds_dir = join(root, 'folds', ds, 'split-0')
    os.makedirs(folds_dir, exist_ok=True)
    centers_v = rng.normal(size=(ncls, 128)) * separation
    centers_b = rng.normal(size=(ncls, 768)) * separation

    for split, n in ((constants.TRAINSET, n_train),
                     (constants.VALIDSET, n_val), (constants.TESTSET, n_test)):
        trials, lengths, lines = [], [], []
        for i in range(n):
            trial = f'{split}/v{i}'
            label = int(rng.integers(0, ncls))
            length = int(rng.integers(min_len, max_len + 1))
            tdir = join(feat_dir, trial)
            os.makedirs(tdir, exist_ok=True)
            partner, obs = _video_hardness(rng, label, ncls, ambiguity,
                                           label_noise)
            np.save(join(tdir, f'{constants.VGGISH}.npy'),
                    (_class_center(centers_v, label, partner)
                     + rng.normal(size=(length, 128))).astype(np.float32))
            np.save(join(tdir, f'{constants.BERT}.npy'),
                    (_class_center(centers_b, label, partner)
                     + rng.normal(size=(length, 768))).astype(np.float32))
            np.save(join(tdir, f'{constants.EXPR}.npy'),
                    np.full((length,), obs, dtype=np.int64))
            if with_video:
                np.save(join(tdir, 'video.npy'), rng.integers(
                    0, 255, size=(length, 64, 64, 3)).astype(np.uint8))
            trials.append(trial)
            lengths.append(length)
            lines.append(f'{trial},{obs},synthetic transcript {i}')
        _write_split(root, ds, split, trials, lengths, lines)
    flat_yaml.dump({c: i for i, c in enumerate(CLASSES[:ncls])},
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
