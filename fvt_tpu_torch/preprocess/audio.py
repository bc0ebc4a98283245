"""Audio feature extraction: wav conversion, log-mel patches, VGGish
embeddings; the port of ``fvt_tpu/preprocess/audio.py``.

Ports of the upstream ``base/audio.py:32-176`` with the port's VGGish
(``fvt_tpu_torch/models/vggish.py``) doing the embedding on the card.
ffmpeg is invoked when present (video -> 16 kHz mono wav,
audio.py:32-51); extraction from existing wavs works without it.

The log-mel patches are computed on ``device`` (``melspec``) and stay
there for the VGGish; ``logmel.npy`` is cast to float16 where the patches
lie (round to nearest even, as numpy's cast) before it comes to the host.
The entry points take ``device=None`` to mean the card and raise where
there is none.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np
import torch

from fvt_tpu_torch.models.vggish import EMBEDDING_DIM, VGGish
from fvt_tpu_torch.preprocess import melspec


def has_ffmpeg() -> bool:
    return shutil.which('ffmpeg') is not None


def convert_video_to_wav(input_path: str, output_path: str,
                         sample_rate: int = 16000) -> str:
    """ffmpeg -i in -vn -ar 16000 -ac 1 out.wav (idempotent).

    ffmpeg writes to a temp name that is renamed only on success: the
    isfile idempotency gate would otherwise happily reuse a HALF-written
    wav from an interrupted conversion forever, silently truncating
    every downstream logmel/vggish feature."""
    if os.path.isfile(output_path):
        return output_path
    assert has_ffmpeg(), 'ffmpeg not available'
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    tmp = f'{output_path}.{os.getpid()}.tmp.wav'
    try:
        subprocess.run(
            ['ffmpeg', '-y', '-loglevel', 'error', '-i', input_path, '-vn',
             '-ar', str(sample_rate), '-ac', '1', tmp],
            check=True)
        os.replace(tmp, output_path)
    finally:
        if os.path.isfile(tmp):
            os.remove(tmp)
    return output_path


def _pad_to_annotated(matrix: np.ndarray, annotated_idx: np.ndarray
                      ) -> np.ndarray:
    """Edge-pad the last element so every annotated index exists
    (audio.py:162-172).  A fully-empty matrix (no patches survived
    framing, e.g. a sub-window clip whose single patch was dropped
    upstream; a zero-length wav itself is silence-padded to >=1 patch in
    melspec.wavfile_to_examples) degrades to zeros instead of the
    reference's IndexError; the driver records the issue per sample."""
    length = int(max(annotated_idx))
    if len(matrix) == 0:
        return np.zeros((length + 1,) + matrix.shape[1:], matrix.dtype)
    diff = length - len(matrix) + 1
    if diff > 0:
        pad = np.repeat(matrix[-1][None], diff, axis=0)
        matrix = np.concatenate([matrix, pad], axis=0)
    return matrix


def extract_logmel(input_path: str, output_path: str,
                   window_sec: float = 0.96, hop_sec: float = 0.04,
                   annotated_idx: Optional[np.ndarray] = None,
                   device=None):
    """wav -> (n_frames, 96, 64) float16 log-mel patches -> .npy
    (audio.py:151-176); one patch per annotated video frame.  The patches
    are computed on ``device`` (None: the card)."""
    device = melspec.resolve_device(device)
    if os.path.isfile(output_path):
        return
    patches = melspec._wavfile_examples(input_path, window_sec, hop_sec,
                                        device)
    # float16 unconditionally: the reference's disk contract
    # (base/audio.py:176) casts before save on every path
    patches = patches.half().cpu().numpy()
    if annotated_idx is not None:
        patches = _pad_to_annotated(patches, annotated_idx)[annotated_idx]
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    np.save(output_path, patches)


def vggish_from_pth(pth: str, device=None) -> VGGish:
    """The port's VGGish from an upstream ``vggish.pth`` state_dict (the
    preprocessing driver's ``--vggish_pth``; its names are the port's own,
    so the load is strict), on ``device`` (None: the card), built once
    for every trial."""
    device = melspec.resolve_device(device)
    model = VGGish()
    model.load_state_dict(torch.load(pth, map_location='cpu'), strict=True)
    return model.to(device).eval()


def extract_vggish_embeddings(input_path: str,
                              vggish: VGGish,
                              window_sec: float,
                              hop_sec: float,
                              input_size: int = 500,
                              annotated_idx: Optional[np.ndarray] = None,
                              device=None) -> np.ndarray:
    """wav -> VGGish 128-d embedding per video frame (audio.py:120-148 +
    base/preprocessing.py:928-1018), in chunks of ``input_size`` patches.

    ``vggish`` is the port's VGGish, built and put on ``device`` (None:
    the card) once by the caller: from an upstream ``vggish.pth``
    (:func:`vggish_from_pth`) or from ``fvt_tpu``'s params through
    ``models.from_jax.vggish_state_from_flax``.  Its input is the float32
    patches on the device, not the float16 copy on disk; the last chunk
    is not padded (there is no jit, and the rows are independent).  Its
    convolutions and products run with TF32 off whatever the caller set.
    """
    device = melspec.resolve_device(device)
    where = {p.device for p in vggish.parameters()}
    if where != {device}:
        raise ValueError(f'the VGGish lies on {where}, the patches on '
                         f'{device}: put it there once, before the trials')
    examples = melspec._wavfile_examples(input_path, window_sec, hop_sec,
                                         device).float()
    with torch.inference_mode(), melspec.no_tf32():
        outs = [vggish(examples[start:start + input_size])
                for start in range(0, len(examples), input_size)]
        embeddings = (torch.cat(outs).float().cpu().numpy() if outs
                      else np.zeros((0, EMBEDDING_DIM), np.float32))

    # the reference pipeline loses the FIRST embedding row: np.savetxt
    # writes no header (base/audio.py:148) and compact_audio_feature
    # reads the csv back with pandas' default header='infer'
    # (base/preprocessing.py:1003-1005), which consumes row 0 as column
    # names.  Reference vggish.npy[i] therefore holds patch i+1; this
    # quirk DEFINES the disk contract, so it is reproduced here.
    embeddings = embeddings[1:]

    if annotated_idx is not None:
        embeddings = _pad_to_annotated(embeddings, annotated_idx)
        embeddings = embeddings[annotated_idx]
    return embeddings
