"""Pickle / npy IO helpers (feature-store side of the disk contract): a
copy of ``fvt_tpu/utils/io.py``, held equal to it by
``tests/test_torch_copies.py``."""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np


def load_pickle(path: str) -> Any:
    with open(path, 'rb') as f:
        return pickle.load(f)


def save_pickle(obj: Any, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_npy(trial_path: str, feature: str, mmap: bool = True) -> np.ndarray:
    """Load ``<trial_path>/<feature>.npy`` (the per-trial store contract,
    upstream project's base/dataset.py:603-619)."""
    filename = os.path.join(trial_path, feature + '.npy')
    return np.load(filename, mmap_mode='c' if mmap else None)


def npy_exists(trial_path: str, feature: str) -> bool:
    return os.path.isfile(os.path.join(trial_path, feature + '.npy'))
