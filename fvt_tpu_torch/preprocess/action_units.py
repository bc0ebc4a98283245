"""Facial landmarks -> action-unit heatmaps (aux research viz) on the
card; the port of ``fvt_tpu/preprocess/action_units.py``.

Slim counterpart of the upstream's dlib/face_landmarks/action_units.py
(1.4k LoC of research visualization): AU center estimation from
68-point landmarks (standard JAA-Net-style landmark-offset rules,
``fvt_tpu``'s numpy) and batched elliptical-Gaussian heatmap rendering
as one program on ``device`` (None: the card).  Not part of the training
path — provided for parity of the aux tooling surface.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from fvt_tpu_torch.train.steps import resolve_device

# 68-pt iBUG indexing (0-based)
L_BROW_IN, R_BROW_IN = 21, 22
L_BROW_MID, R_BROW_MID = 19, 24
L_EYE_OUT, R_EYE_OUT = 36, 45
L_EYE_IN, R_EYE_IN = 39, 42
NOSE_ROOT, NOSE_TIP = 27, 33
L_NOSE_WING, R_NOSE_WING = 31, 35
L_MOUTH, R_MOUTH = 48, 54
MOUTH_TOP, MOUTH_BOT = 51, 57
CHIN = 8


def _eye_dist(lms: np.ndarray) -> float:
    return float(np.linalg.norm(lms[L_EYE_IN] - lms[R_EYE_IN]) + 1e-6)


def au_centers(landmarks: np.ndarray) -> Dict[str, np.ndarray]:
    """AU -> (2, 2) left/right center points from 68-pt landmarks.

    Offset rules follow the common AU-localisation literature (inner brow
    raise above brow inner corners, cheek raise below eyes, lip corner
    pull at mouth corners, ...).
    """
    lms = np.asarray(landmarks, dtype=np.float32)
    assert lms.shape == (68, 2), lms.shape
    d = _eye_dist(lms) / 2.0
    up = np.array([0.0, -1.0]) * d
    down = -up

    def pair(a, b, off=0.0):
        o = np.array([0.0, off])
        return np.stack([lms[a] + o, lms[b] + o])

    return {
        'AU1': np.stack([lms[L_BROW_IN] + up / 2, lms[R_BROW_IN] + up / 2]),
        'AU2': np.stack([lms[L_BROW_MID] + up / 3,
                         lms[R_BROW_MID] + up / 3]),
        'AU4': pair(L_BROW_IN, R_BROW_IN),
        'AU6': np.stack([lms[L_EYE_OUT] + down, lms[R_EYE_OUT] + down]),
        'AU9': np.stack([lms[L_NOSE_WING], lms[R_NOSE_WING]]),
        'AU12': pair(L_MOUTH, R_MOUTH),
        'AU25': np.stack([lms[MOUTH_TOP], lms[MOUTH_BOT]]),
        'AU26': np.stack([lms[MOUTH_BOT], lms[CHIN]]),
    }


def _render_heatmaps(centers: torch.Tensor, sigmas: torch.Tensor,
                     grid: torch.Tensor) -> torch.Tensor:
    """centers (T, K, 2, 2), sigmas (T, K, 2): elliptical gaussians, max
    over the left/right pair.  grid (H*W, 2).  Returns (T, K, H*W)."""
    diff = grid[None, None, None] - centers[:, :, :, None, :]  # T,K,2,HW,2
    sx = sigmas[:, :, 0][:, :, None, None]
    sy = sigmas[:, :, 1][:, :, None, None]
    z = (diff[..., 0] ** 2) / (2 * sx ** 2) \
        + (diff[..., 1] ** 2) / (2 * sy ** 2)
    heat = torch.exp(-z)                      # (T, K, 2, HW)
    return heat.amax(dim=2)


def _grid(image_size: int, device: torch.device) -> torch.Tensor:
    ys, xs = np.mgrid[0:image_size, 0:image_size]
    return torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], axis=1
                                     ).astype(np.float32)).to(device)


def au_heatmaps(landmarks: np.ndarray, image_size: int = 256,
                sigma_frac: Tuple[float, float] = (0.10, 0.07),
                device=None) -> Dict[str, np.ndarray]:
    """AU name -> (H, W) float32 heatmap for one face, rendered on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    centers = au_centers(landmarks)
    names = list(centers)
    c = np.stack([centers[n] for n in names]).astype(np.float32)
    d = _eye_dist(np.asarray(landmarks))
    sig = np.tile(np.array([[sigma_frac[0] * d, sigma_frac[1] * d]],
                           dtype=np.float32), (len(names), 1))
    heat = _render_heatmaps(torch.from_numpy(c[None]).to(device),
                            torch.from_numpy(sig[None]).to(device),
                            _grid(image_size, device))[0].cpu().numpy()
    return {n: heat[i].reshape(image_size, image_size)
            for i, n in enumerate(names)}


def batched_au_heatmaps(landmarks: np.ndarray, image_size: int = 128,
                        device=None) -> np.ndarray:
    """(T, 68, 2) -> (T, K, H, W) heatmaps, one pass over the frames on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    T = landmarks.shape[0]
    all_centers, all_sigmas = [], []
    for t in range(T):
        cs = au_centers(landmarks[t])
        d = _eye_dist(np.asarray(landmarks[t]))
        all_centers.append(np.stack(list(cs.values())))
        all_sigmas.append(np.tile(np.array([[0.10 * d, 0.07 * d]],
                                           dtype=np.float32),
                                  (len(cs), 1)))
    centers = np.stack(all_centers).astype(np.float32)  # (T, K, 2, 2)
    sigmas = np.stack(all_sigmas)                       # (T, K, 2)
    out = _render_heatmaps(torch.from_numpy(centers).to(device),
                           torch.from_numpy(sigmas).to(device),
                           _grid(image_size, device))
    k = centers.shape[1]
    return out.cpu().numpy().reshape(T, k, image_size, image_size)
