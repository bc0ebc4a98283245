"""The group video transforms (``fvt_tpu/data/transforms.py:59-98``).

uint8 face crops ``(B, T, H, W, 3)`` -> normalised float32
``(B, T, 40, 40, 3)``.

Eval: a 40^2 input is taken as already cropped and only scaled; anything
else is resized to 48^2 (a no-op at 48^2) through the antialiased bilinear
matrices of ``fvt_tpu_torch.data.host_resize``, then center-cropped at
``center_crop_offset``; then ``/255`` and ``(x - 0.5) / 0.5``.

Train: resized to 48^2 the same way, then one random 40^2 crop and one
random horizontal flip a window, shared by all its frames (the group
semantics of ``fvt_tpu``'s ``train_video_transform``), then the same
scaling.  :func:`train_video_transform` takes the offsets and flips as
arguments, so that a caller can inject them; :func:`draw_crop_flip` draws
them from a generator on the video's device, offsets uniform in
``[0, 8]`` and flips with probability 1/2.  The draws are PyTorch's, not
JAX's: the same generator gives the same crops here, not there.
"""
from __future__ import annotations

import torch

from fvt_tpu_torch.data.host_resize import resize_weights
from fvt_tpu_torch.parallel import collectives

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


def draw_crop_flip(batch: int, generator: torch.Generator) -> tuple:
    """(offs_h, offs_w, flip), each (batch,), for
    :func:`train_video_transform`, drawn from ``generator`` on its device
    in that order."""
    device = generator.device
    hi = SCALE_SIZE - CROP_SIZE + 1
    # in a sharded data-parallel step: the global batch's draws, this
    # rank's rows of them
    n, lo, top = collectives.rows(batch)
    offs_h = torch.randint(0, hi, (n,), generator=generator, device=device)
    offs_w = torch.randint(0, hi, (n,), generator=generator, device=device)
    flip = torch.rand(n, generator=generator, device=device) < 0.5
    return offs_h[lo:top], offs_w[lo:top], flip[lo:top]


def train_video_transform(video: torch.Tensor, offs_h: torch.Tensor,
                          offs_w: torch.Tensor, flip: torch.Tensor
                          ) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 or float -> (B, T, 40, 40, 3) float32: window
    b cropped at rows ``offs_h[b]:+40`` and columns ``offs_w[b]:+40`` of
    its 48^2 frames, its columns reversed where ``flip[b]``.  One gather,
    no host synchronisation on the offsets."""
    x = _resize_frames(video.to(torch.float32), SCALE_SIZE)
    b = x.shape[0]
    ar = torch.arange(CROP_SIZE, device=x.device)
    rows = offs_h.to(x.device)[:, None] + ar
    cols = offs_w.to(x.device)[:, None] + torch.where(
        flip.to(x.device)[:, None], CROP_SIZE - 1 - ar, ar)
    bi = torch.arange(b, device=x.device)[:, None, None]
    # advanced indices around a slice: their (B, 40, 40) comes first
    x = x[bi, :, rows[:, :, None], cols[:, None, :]]
    x = x.permute(0, 3, 1, 2, 4).contiguous()
    x = x / 255.0
    return (x - 0.5) / 0.5


def eval_video_transform(video: torch.Tensor) -> torch.Tensor:
    x = video.to(torch.float32)
    if not (x.shape[2] == CROP_SIZE and x.shape[3] == CROP_SIZE):
        x = _resize_frames(x, SCALE_SIZE)
        off = center_crop_offset(SCALE_SIZE, CROP_SIZE)
        x = x[:, :, off:off + CROP_SIZE, off:off + CROP_SIZE, :]
    x = x / 255.0
    return (x - 0.5) / 0.5
