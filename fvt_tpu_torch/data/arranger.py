"""DataArranger: raw trial list -> per-split windowed work lists + stats.
A copy of ``fvt_tpu/data/arranger.py`` on the port's modules.

Re-design of the upstream base/dataset.py:25-453 and dataset.py:39-85.
All randomness goes through explicit numpy Generators (no global RNG).
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from fvt_tpu_torch import constants
from fvt_tpu_torch.data import folds as folds_mod
from fvt_tpu_torch.data import windowing as W
from fvt_tpu_torch.utils.io import load_npy
from fvt_tpu_torch.utils import rng as rng_mod
from fvt_tpu_torch.utils.logger import log, fmsg


class DataArranger:
    """Builds split lists from fold files and the on-disk feature store.

    Args mirror the reference: ``dataset_info`` is the per-split
    ``dataset_info_{ds}_{split}.pkl`` content with 'data_folder', 'trial',
    'length' entries (base/dataset.py:379-410).
    """

    def __init__(self, args, dataset_info: dict, dataset_path: str,
                 fold_to_run: int, folds_dir: str):
        self.args = args
        assert os.path.isdir(folds_dir), folds_dir
        self.fold_to_run = fold_to_run
        self.folds_dir = folds_dir
        self.dataset_info = dataset_info

        self.trial_list = self.generate_raw_trial_list(dataset_path)

        cl_int = folds_mod.load_class_id(folds_dir, fold_to_run)
        self.cl_to_int: dict = cl_int
        self.int_to_cl: dict = folds_mod.switch_key_val(cl_int)

        self.data_per_split = self.create_splits()

    # ------------------------------------------------------------- raw list
    def generate_raw_trial_list(self, dataset_path: str) -> list:
        trial_list = []
        for partition in self.dataset_info:
            part = self.dataset_info[partition]
            trial_path = os.path.join(dataset_path, 'features',
                                      part['data_folder'])
            for idx, trial in enumerate(part['trial']):
                path = os.path.join(trial_path, trial)
                length = part['length'][idx]
                # C-EXPR-DB*: trust video.npy over the recorded length
                # (base/dataset.py:400-409)
                if self.args.dataset_name in (constants.C_EXPR_DB,
                                              constants.C_EXPR_DB_CHALLENGE):
                    vid = load_npy(path, constants.VIDEO)
                    length = vid.shape[0]
                trial_list.append([path, trial, int(length)])
        return trial_list

    # --------------------------------------------------------------- splits
    def create_splits(self) -> Dict[str, list]:
        j = self.fold_to_run
        data_per_split: Dict[str, list] = {}
        by_trial = {t: i for i, (_, t, _) in enumerate(self.trial_list)}

        for split in self.dataset_info:
            path_fold = os.path.join(self.folds_dir, f"split-{j}",
                                     f"{split}.txt")
            fold = folds_mod.load_fold_txt(path_fold)

            drop_other = (self.args.dataset_name == constants.C_EXPR_DB
                          and not self.args.use_other_class)
            if drop_other:
                other_int = self.cl_to_int[constants.OTHER]
                assert other_int == 7, other_int
                fold = {k: v for k, v in fold.items()
                        if v['cl'] != other_int}

            items, labels = [], []
            for trial in fold:
                if trial in by_trial:
                    items.append(self.trial_list[by_trial[trial]])
                    labels.append([trial, fold[trial]['cl']])

            p = {constants.TRAINSET: self.args.train_p,
                 constants.VALIDSET: self.args.valid_p,
                 constants.TESTSET: self.args.test_p}[split]

            mm = len(items)
            if p < 100.:
                items = self.keep_p_from_split(items, labels, p / 100.)
                if split == constants.TRAINSET:
                    items = rng_mod.stable_shuffle(
                        items, self.args.seed, rounds=1000)
                log(fmsg(f"split: {split} goes from {mm} videos to "
                         f"{len(items)} ({p}%)."))
            else:
                log(fmsg(f"split: {split} was maintained in full {mm} "
                         f"videos ({p}%)."))

            data_per_split[split] = items

        return data_per_split

    def keep_p_from_split(self, data: list, data_with_label: list, p: float
                          ) -> list:
        """Per-class Bernoulli(p) subsampling; at least one sample per class
        (base/dataset.py:143-182)."""
        assert 0 < p <= 1., p
        rng = rng_mod.np_rng(self.args.seed, 'keep_p_from_split')
        cls = [item[1] for item in data_with_label]
        unique = np.unique(np.asarray(cls)).tolist()

        out_data = []
        for cl in unique:
            l, l_cl = [], []
            for i, x in enumerate(cls):
                if x == cl and rng.binomial(n=1, p=p) == 1:
                    l.append(data[i])
                if x == cl:
                    l_cl.append(data[i])
            if not l:
                l = [l_cl[rng.integers(0, len(l_cl))]]
            out_data.extend(l)
        return out_data

    # ------------------------------------------------------------ windowing
    def generate_partitioned_trial_list(self, window_length: int,
                                        hop_length: int,
                                        windowing: bool = True,
                                        window_eval: bool = False
                                        ) -> Dict[str, list]:
        """Per split: list of [path, trial, length, frame-index-array].

        Train splits are windowed; eval splits take the whole trial unless
        ``window_eval`` (base/dataset.py:188-270).
        """
        partitioned: Dict[str, list] = {}
        for split, data_split in self.data_per_split.items():
            partitioned[split] = []
            for path, trial, length in data_split:
                if windowing:
                    if split in (constants.TESTSET, constants.VALIDSET) \
                            and not window_eval:
                        _window = length
                    else:
                        _window = window_length
                else:
                    _window = length

                for index in W.windowing(np.arange(length), _window,
                                         hop_length):
                    partitioned[split].append([path, trial, length, index])
        return partitioned

    # ------------------------------------------------------------ mean/std
    def get_feature_list(self) -> List[str]:
        """Features that get train-stat normalisation (dataset.py:52)."""
        return [constants.VGGISH, constants.BERT]

    def calculate_mean_std(self, partitioned_trial: dict) -> dict:
        """Per-dim mean/std over train+valid (base/dataset.py:272-326)."""
        feature_list = self.get_feature_list()
        data = (partitioned_trial[constants.TRAINSET]
                + partitioned_trial[constants.VALIDSET])

        out = {f: {'mean': None, 'std': None} for f in feature_list}
        for feature in feature_list:
            lengths, sums = 0, 0
            for path, _, _, _ in data:
                samples = np.asarray(load_npy(path, feature))
                assert samples.ndim == 2, samples.ndim
                lengths += samples.shape[0]
                sums = sums + samples.sum(axis=0, dtype=np.float64)
            out[feature]['mean'] = sums / (lengths + 1e-10)

        for feature in feature_list:
            lengths, sq = 0, 0
            avg = out[feature]['mean']
            for path, _, _, _ in data:
                samples = np.asarray(load_npy(path, feature))
                sq = sq + (((samples - avg) ** 2)
                           .sum(axis=0, dtype=np.float64))
                lengths += samples.shape[0]
            out[feature]['std'] = np.sqrt(sq / (lengths - 1))
        return out
