"""Shard/partition math for job-array preprocessing: a copy of
``fvt_tpu/preprocess/sharding.py``, held equal to it by
``tests/test_torch_copies.py``.

Ports of the upstream abaw5_pre_processing/dlib/utils/tools.py:48-82 and
the ``mit.divide`` semantics used for part selection
(project/abaw5/preprocessing.py:121-149) and token->frame block alignment
(base/speech.py:717).
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence

import numpy as np


def chunks_into_n(l: Sequence, n: int) -> Iterable:
    """n chunks of equal ceil size (last may be short/empty)."""
    chunksize = int(math.ceil(len(l) / n))
    return (l[i * chunksize:i * chunksize + chunksize] for i in range(n))


def better_chunks_into_n(l: Sequence, n: int) -> List[list]:
    """np.array_split-balanced chunks (sizes differ by at most 1)."""
    idx = np.array_split(list(range(len(l))), n)
    return [[l[j] for j in chunk] for chunk in idx]


def divide(n: int, iterable: Sequence) -> List[list]:
    """more_itertools.divide semantics: n contiguous groups, earlier groups
    get the extra elements."""
    seq = list(iterable)
    q, r = divmod(len(seq), n)
    out = []
    stop = 0
    for i in range(1, n + 1):
        start = stop
        stop += q + 1 if i <= r else q
        out.append(seq[start:stop])
    return out


def annotated_index(n_frames: int, source_frequency: float,
                    target_frequency: float = None) -> np.ndarray:
    """Per-feature frame index resampling
    (project/abaw5/preprocessing.py:441-454).  For video/vggish/mfcc/
    egemaps/logmel the target frequency equals the source fps, so the
    index is the identity."""
    idx = np.arange(n_frames)
    if target_frequency is None:
        target_frequency = source_frequency
    return np.asarray(
        np.round(target_frequency / source_frequency * idx), dtype=np.int64)
