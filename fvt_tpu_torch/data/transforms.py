"""Eval-mode video transform (``fvt_tpu/data/transforms.py:82-98``).

uint8 face crops ``(B, T, H, W, 3)`` -> normalised float32
``(B, T, 40, 40, 3)``: a 40^2 input is taken as already cropped and only
scaled; anything else is resized to 48^2 (a no-op at 48^2) through the
antialiased bilinear matrices of ``fvt_tpu_torch.data.host_resize``, then
center-cropped at ``center_crop_offset``; then ``/255`` and
``(x - 0.5) / 0.5``.
"""
from __future__ import annotations

import torch

from fvt_tpu_torch.data.host_resize import resize_weights

SCALE_SIZE = 48
CROP_SIZE = 40


def center_crop_offset(size: int, crop: int) -> int:
    """The center-crop offset convention (torch CenterCrop floor)."""
    return (size - crop) // 2


def _resize_frames(video: torch.Tensor, size: int) -> torch.Tensor:
    """(B, T, H, W, C) float -> (B, T, size, size, C), bilinear with
    antialiasing as two separable matrix products."""
    h, w = video.shape[2:4]
    if h == size and w == size:
        return video
    wh = torch.from_numpy(resize_weights(h, size)).to(video.device)
    ww = torch.from_numpy(resize_weights(w, size)).to(video.device)
    x = torch.einsum('sh,bthwc->btswc', wh, video)
    return torch.einsum('pw,btswc->btspc', ww, x)


def eval_video_transform(video: torch.Tensor) -> torch.Tensor:
    x = video.to(torch.float32)
    if not (x.shape[2] == CROP_SIZE and x.shape[3] == CROP_SIZE):
        x = _resize_frames(x, SCALE_SIZE)
        off = center_crop_offset(SCALE_SIZE, CROP_SIZE)
        x = x[:, :, off:off + CROP_SIZE, off:off + CROP_SIZE, :]
    x = x / 255.0
    return (x - 0.5) / 0.5
