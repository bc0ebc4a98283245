"""Pure window-index math: train/eval windowing and overlap-stitching.
A copy of the numpy half of ``fvt_tpu/data/windowing.py``, held equal to
it by ``tests/test_torch_copies.py``.

The upstream project computes windows with per-item Python loops
(its base/dataset.py:434-453, trainer.py:894-912) and stitches eval
windows with a Counter-based scatter loop (trainer.py:832-892).  Here
both are precomputed index matrices + a single vectorised scatter-add.

Window rule (identical to both reference variants):
  * if length > window:  windows start at 0, hop, 2*hop, ... while a full
    window fits; if the last full window does not touch the final frame, an
    extra tail window [length-window, length) is appended.
  * else: a single window covering the whole sequence.
"""
from __future__ import annotations

from typing import List

import numpy as np


def window_starts(length: int, window_length: int, hop_length: int) -> List[int]:
    """Start offsets of each window (reference windowing rule)."""
    if length <= window_length:
        return [0]
    steps = (length - window_length) // hop_length + 1
    starts = [i * hop_length for i in range(steps)]
    if starts[-1] + window_length - 1 < length - 1:
        starts.append(length - window_length)
    return starts


def windowing(x: np.ndarray, window_length: int, hop_length: int
              ) -> List[np.ndarray]:
    """Reference-identical list-of-index-arrays windowing.

    For ``len(x) <= window_length`` returns ``[x]`` (the short window is NOT
    padded here; padding semantics live in the dataset layer).
    """
    length = len(x)
    if length <= window_length:
        return [x]
    return [x[s:s + window_length]
            for s in window_starts(length, window_length, hop_length)]


def window_index_matrix(length: int, window_length: int, hop_length: int
                        ) -> np.ndarray:
    """(num_windows, window_length) int32 gather matrix.

    Only defined for ``length >= window_length`` (the stitched-eval path).
    """
    assert length >= window_length, (length, window_length)
    starts = np.asarray(
        window_starts(length, window_length, hop_length), dtype=np.int32)
    return starts[:, None] + np.arange(window_length, dtype=np.int32)[None, :]


def stitch_windows_np(window_outputs: np.ndarray,
                      index_matrix: np.ndarray, length: int) -> np.ndarray:
    """THE stitch: one scatter-average reproducing the reference's
    Counter division (trainer.py:870-890).

    Host-side numpy on purpose: the stitch runs once per video over a
    (num_windows, window, C) logits block that is already on the host
    for metric computation, and keeping ONE implementation (used by both
    the pooled wqueue path and the per-video test oracle,
    trainer.py:276/348) prevents parallel-implementation drift.  The
    jnp / masked / padded variants that used to live here had no
    non-test callers and were removed (round-3 cleanup)."""
    n, w, ncls = window_outputs.shape
    flat = index_matrix.reshape(-1)
    summed = np.zeros((length, ncls), np.float32)
    counts = np.zeros((length,), np.float32)
    np.add.at(summed, flat, window_outputs.reshape(-1, ncls)
              .astype(np.float32))
    np.add.at(counts, flat, 1.0)
    # a frame covered by NO window (possible when hop > window, a
    # degenerate-but-accepted config) must stay 0 like the reference's
    # Counter division, which only divides indices that appeared —
    # summed/counts alone would emit NaN there and poison compute_perf
    return summed / np.maximum(counts, 1.0)[:, None]


def ladder_len(true_len: int, window_length: int, quantum: int = 0,
               growth: float = 1.3) -> int:
    """Smallest ladder length >= ``true_len``.

    The device-side windowed eval path (trainer.inference with
    --eval_device_windows) uploads each long video ONCE and gathers its
    windows on device; padding the upload to a ladder caps the number
    of distinct compile shapes.  Below ``4 * window_length`` the ladder
    is LINEAR in ``quantum`` steps (pad waste < quantum frames — most
    real videos land here, and a geometric step rounded up to quantum
    could waste ~50% of the transfer: 401 frames previously shipped as
    600); beyond that it grows geometrically by ``growth``, so the
    shape count stays O(3*window/quantum + log(L/window)).
    """
    assert true_len > window_length, (true_len, window_length)
    assert growth > 1.0, growth  # <=1 would never reach true_len: hang
    quantum = quantum or min(100, window_length)
    linear_cap = 4 * window_length
    if true_len <= linear_cap:
        return int(-(-true_len // quantum) * quantum)
    v = linear_cap
    while v < true_len:
        v = int(-(-v * growth // quantum) * quantum)
    return v


def pad_short_window_indices(length: int, window_length: int) -> np.ndarray:
    """Frame-gather indices reproducing the reference pad-by-repeat rule.

    A trial shorter than the window is zero-padded then the tail is filled
    with copies of the LAST real frame (base/dataset.py:570-582) — labels
    included.  Expressed as a gather: [0, 1, ..., L-1, L-1, ..., L-1].
    """
    assert length < window_length, (length, window_length)
    idx = np.arange(window_length, dtype=np.int32)
    idx[length:] = length - 1
    return idx
