"""Offline visual feature extraction: face crops -> ArcFace embeddings on
the card; the port of ``fvt_tpu/preprocess/visual.py``.

The upstream's extractor chain has a 'cnn' step (base/preprocessing.py
extract_cnn_fn path; tcn_settings 'cnn'/'cnn_res50', configs.py:85-94)
producing per-frame 512-d ResNet features so training can consume
precomputed embeddings instead of raw frames.  Here the whole video runs
through the port's ``VisualBackbone`` (its default conv path) after
``data/transforms.eval_video_transform``, in chunks of ``batch`` frames
on ``device`` (None: the card), in float32 with TF32 off.  The last chunk
is not padded: nothing is compiled for a fixed shape, and the frames are
independent.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from fvt_tpu_torch.data.transforms import eval_video_transform
from fvt_tpu_torch.models.arcface import VisualBackbone
from fvt_tpu_torch.preprocess.melspec import no_tf32
from fvt_tpu_torch.train.steps import resolve_device

EMBEDDING_DIM = 512


def backbone_from_pth(pth: str, device=None) -> VisualBackbone:
    """The port's VisualBackbone from an upstream ``res50_ir_*.pth`` state
    dict (keys rooted at ``backbone.``; the driver's ``--arcface_pth``),
    ``strict=True``, on ``device`` (None: the card), in eval mode."""
    device = resolve_device(device)
    model = VisualBackbone()
    model.load_state_dict(torch.load(pth, map_location='cpu'), strict=True)
    return model.to(device).eval()


def extract_cnn_features(video: np.ndarray, backbone: VisualBackbone,
                         batch: int = 512, device=None) -> np.ndarray:
    """(T, H, W, 3) uint8 face crops -> (T, 512) ArcFace embeddings.

    Applies the eval transform (resize 48 -> center crop 40 -> normalize
    — the crop size is fixed by the transform, data/transforms.py) then
    the frozen backbone, which must lie on ``device`` already (put it
    there once, before the trials).
    """
    device = resolve_device(device)
    where = {p.device for p in backbone.parameters()}
    if where != {device}:
        raise ValueError(f'the backbone lies on {where}, the frames go to '
                         f'{device}: put it there once, before the trials')
    out = np.zeros((video.shape[0], EMBEDDING_DIM), dtype=np.float32)
    with torch.inference_mode(), no_tf32():
        for start in range(0, video.shape[0], batch):
            chunk = torch.from_numpy(np.ascontiguousarray(
                video[start:start + batch])).to(device)
            x = eval_video_transform(chunk[None])[0]
            out[start:start + len(chunk)] = backbone(x).cpu().numpy()
    return out


def extract_cnn_to_npy(trial_dir: str, backbone: VisualBackbone,
                       feature_name: str = 'cnn', device=None):
    """video.npy -> <feature_name>.npy in the same per-trial store."""
    out_path = os.path.join(trial_dir, f'{feature_name}.npy')
    if os.path.isfile(out_path):
        return
    video = np.load(os.path.join(trial_dir, 'video.npy'))
    feats = extract_cnn_features(video, backbone, device=device)
    np.save(out_path, feats)
