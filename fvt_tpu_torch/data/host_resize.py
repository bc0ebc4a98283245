"""Host-side video-frame resize (256 -> 48) for H2D volume reduction:
a copy of ``fvt_tpu/data/host_resize.py`` (numpy only), held equal to it
by ``tests/test_torch_copies.py``.

The disk contract stores 256x256 uint8 faces (upstream configs.py:20,
faces.py OUT_SIZE=256) but the model consumes 48->40 crops; resizing on
device means shipping 196 KB/frame over PCIe where 7 KB/frame
suffices (a 28x H2D reduction on the challenge-inference hot path).

The kernel is the antialiased triangle (bilinear) kernel of the JAX
package's device transform (``image.resize``) — implemented as two precomputed sparse weight
matrices (separable linear map), applied with BLAS — so the host path
matches the device path to fp32 tolerance before the uint8 round.  The
round to uint8 mirrors the upstream pipeline, which materializes
uint8 PIL images after GroupScale(48) (base/transforms3D.py:23-40).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=16)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) antialiased triangle-kernel weights, matching
    the JAX package's device-side bilinear resize along one axis."""
    scale = n_out / n_in
    out_idx = np.arange(n_out, dtype=np.float64)
    # sample coordinate of each output pixel in input space
    sample = (out_idx + 0.5) / scale - 0.5
    in_idx = np.arange(n_in, dtype=np.float64)
    # antialiasing: kernel stretched by 1/scale when downsampling
    stretch = max(1.0, 1.0 / scale)
    w = 1.0 - np.abs(sample[:, None] - in_idx[None, :]) / stretch
    w = np.clip(w, 0.0, None)
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def resize_frames(video: np.ndarray, size: int) -> np.ndarray:
    """(T, H, W, C) -> (T, size, size, C) float32, bilinear+antialias.

    Shaped as two batched BLAS gemms with contiguous operands, which is
    much faster on the host than the einsum formulation.
    """
    t, h, w, c = video.shape
    wh = resize_weights(h, size)
    ww = resize_weights(w, size)
    # rows: (size, h) @ (t, h, w*c) -> (t, size, w*c), batched gemm
    x = video.reshape(t, h, w * c).astype(np.float32)
    y = np.matmul(wh, x)
    # cols: channels to the fore so w is the contraction's minor axis
    y = np.ascontiguousarray(
        y.reshape(t, size, w, c).transpose(0, 1, 3, 2))  # (t, size, c, w)
    z = np.matmul(y, ww.T)                               # (t, size, c, size)
    return np.ascontiguousarray(z.transpose(0, 1, 3, 2))


def resize_frames_uint8(video: np.ndarray, size: int) -> np.ndarray:
    """Resize + round to uint8 (upstream's GroupScale materializes
    uint8 PIL images too)."""
    x = resize_frames(video, size)
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)
