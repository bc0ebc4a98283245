"""bfloat16 on the host without ``ml_dtypes``, which the card's machine
lacks: a bfloat16 array is carried as its raw bits, ``uint16``.

``--h2d_bf16_features`` ships the feature streams to the device in
bfloat16 (``fvt_tpu/streaming.py:77-79``, ``tools/infer_artifact.py:86-91``,
``train/trainer.py`` ``maybe_cast``: ``astype(ml_dtypes.bfloat16)`` on the
host, widened to float32 on the device).  :func:`bf16_bits` rounds as
``ml_dtypes``' ``astype`` does, bit for bit; :func:`as_bits` takes what a
caller may hand a bfloat16 input (float values to round, raw bits, or an
``ml_dtypes`` array), :func:`to_device` ships the bits and widens them on
the device.
"""
from __future__ import annotations

import numpy as np

BF16 = 'bfloat16'


def bf16_bits(arr) -> np.ndarray:
    """float32 values -> the bits (uint16) of the nearest bfloat16, ties
    to even; a NaN becomes the quiet NaN of its sign (0x7fc0), and values
    past the largest bfloat16 round to infinity, as ``ml_dtypes``."""
    b = np.ascontiguousarray(arr, np.float32).view(np.uint32)
    r = ((b + np.uint32(0x7fff) + ((b >> 16) & np.uint32(1))) >> 16).astype(
        np.uint16)
    nan = (b & np.uint32(0x7fffffff)) > np.uint32(0x7f800000)
    if nan.any():
        r[nan] = ((b[nan] >> 16) & 0x8000 | 0x7fc0).astype(np.uint16)
    return r


def as_bits(arr) -> np.ndarray:
    """The bfloat16 bits (uint16) of ``arr``: raw bits as they are, an
    ``ml_dtypes`` bfloat16 array's bits, anything else rounded by
    :func:`bf16_bits`."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:
        return arr
    if arr.dtype.name == BF16:
        return arr.view(np.uint16)
    return bf16_bits(arr)


def numpy_dtype(name: str) -> np.dtype:
    """The numpy dtype that carries an input spec's dtype ``name``."""
    return np.dtype(np.uint16) if name == BF16 else np.dtype(name)


def to_device(bits: np.ndarray, device):
    """bfloat16 bits (uint16) -> a bfloat16 tensor on ``device``: two bytes
    a value cross to the device."""
    import torch
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16))
    return t.to(device, non_blocking=True).view(torch.bfloat16)
