"""Fold-file parsing (folds/<ds>/split-<k>/{train,val,test}.txt +
class_id.yaml): ``fvt_tpu/data/folds.py`` with ``class_id.yaml`` read by
:mod:`fvt_tpu_torch.config.flat_yaml` (no PyYAML).

Line format: ``<video_id>,<label_int>,<transcript>`` — the transcript may
itself contain commas (upstream base/dataset.py:63-74).
"""
from __future__ import annotations

import os
from typing import Dict

from fvt_tpu_torch.config import flat_yaml


def load_fold_txt(path_fold: str) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    with open(path_fold, 'r') as f:
        for line in f.readlines():
            line = line.strip('\n')
            if not line:
                continue
            v_id, cl_int = line.split(',')[0:2]
            txt = line.replace(f"{v_id},{cl_int},", '')
            assert v_id not in out, v_id
            out[v_id] = {'cl': int(cl_int), 'txt': txt}
    return out


def load_class_id(folds_dir: str, fold: int) -> Dict[str, int]:
    path = os.path.join(folds_dir, f"split-{fold}", 'class_id.yaml')
    return flat_yaml.load(path)


def switch_key_val(d: dict) -> dict:
    out = {}
    for k in d:
        assert d[k] not in out, 'duplicate value in class map'
        out[d[k]] = k
    return out
