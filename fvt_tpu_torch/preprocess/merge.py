"""Shard merge: dataset_info / processing_records parts -> per-split
master; a copy of ``fvt_tpu/preprocess/merge.py``, held equal to it by
``tests/test_torch_copies.py``.

The upstream's post_feature_extract.py:49-165, including the pairing
asserts (every dataset_info shard must have its records twin) and
numeric part ordering.
"""
from __future__ import annotations

import argparse
import copy
import os
from os.path import join
from typing import List, Tuple

from fvt_tpu_torch import constants
from fvt_tpu_torch.utils.io import load_pickle, save_pickle
from fvt_tpu_torch.utils.logger import log


def get_pairs(features_path: str, ds: str, split: str
              ) -> List[Tuple[str, str]]:
    s = f'dataset_info_{ds}_{split}_'
    files = [f for f in os.listdir(features_path)
             if f.startswith(s) and f.endswith('.pkl')]
    files.sort(key=lambda f: int(f.split('_')[-1].split('.')[0]))

    s2 = f'processing_records_{ds}_{split}_'
    pairs = [(f, f.replace(s, s2)) for f in files]
    for di, pr in pairs:
        assert os.path.isfile(join(features_path, di)), di
        assert os.path.isfile(join(features_path, pr)), pr
    log(f"Found {len(pairs)} shard pairs for {ds} {split}")
    return pairs


def check_generations(features_path: str, pairs) -> None:
    """Refuse mixed extractor generations BEFORE anything is written:
    mixing generations inside one store silently changes per-frame
    features (preprocess/version.py), and a refusal that has already
    overwritten the records master would leave the store inconsistent."""
    from fvt_tpu_torch.preprocess.version import STAMP_KEY

    first = None
    for i, (di, _) in enumerate(pairs):
        stamp = load_pickle(join(features_path, di)).get(STAMP_KEY)
        if i == 0:
            first = (di, stamp)
        elif stamp != first[1]:
            raise ValueError(
                f'shard {di} was built by extractor generation '
                f'{stamp} but {first[0]} by {first[1]}; re-run the '
                f'stale shards before merging')


def merge_dataset_info(features_path: str, pairs, ds: str, split: str):
    check_generations(features_path, pairs)
    out = None
    for i, (di, _) in enumerate(pairs):
        data = load_pickle(join(features_path, di))
        if i == 0:
            out = copy.deepcopy(data)
        else:
            for key in ('trial', 'trial_no', 'length', 'partition',
                        'pseudo_partition', 'subject_no'):
                out[key].extend(data[key])
    save_pickle(out, join(features_path,
                          f'dataset_info_{ds}_{split}.pkl'))
    return out


def merge_processing_records(features_path: str, pairs, ds: str,
                             split: str):
    out = []
    for _, pr in pairs:
        data = load_pickle(join(features_path, pr))
        assert isinstance(data, list), type(data)
        out.extend(data)
    save_pickle(out, join(features_path,
                          f'processing_records_{ds}_{split}.pkl'))
    return out


def merge_results(features_path: str, ds: str, split: str):
    pairs = get_pairs(features_path, ds, split)
    if not pairs:
        log(f"no shards for {ds} {split}; skipping merge")
        return None
    check_generations(features_path, pairs)  # before any write
    merge_processing_records(features_path, pairs, ds, split)
    return merge_dataset_info(features_path, pairs, ds, split)


def splits_for(ds: str) -> list:
    if ds == constants.C_EXPR_DB_CHALLENGE:
        return [constants.TRAINSET]
    if ds == constants.C_EXPR_DB:
        return [constants.TRAINSET, constants.VALIDSET]
    if ds == constants.MELD:
        return [constants.TRAINSET, constants.VALIDSET, constants.TESTSET]
    raise NotImplementedError(ds)


def main(argv=None):
    p = argparse.ArgumentParser(description='merge preprocessing shards')
    p.add_argument('--dataset_name', required=True)
    p.add_argument('--features_path', required=True)
    args = p.parse_args(argv)
    for split in splits_for(args.dataset_name):
        merge_results(args.features_path, args.dataset_name, split)


if __name__ == '__main__':
    main()
