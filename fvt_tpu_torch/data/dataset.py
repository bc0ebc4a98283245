"""Example assembly from the per-trial .npy feature store: a copy of
``fvt_tpu/data/dataset.py`` on the port's modules.

Host-side counterpart of the upstream base/dataset.py:456-631: mmap-slice
each modality, reproduce the pad-by-repeat rule for short trials (labels
included), and normalize feature streams with the train-split stats.
Raw video windows stay uint8; the batched device transform handles
resize/crop/normalize (``fvt_tpu_torch.data.transforms``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import model_config as MC
from fvt_tpu_torch.data.transforms import SCALE_SIZE
from fvt_tpu_torch.data.windowing import pad_short_window_indices
from fvt_tpu_torch.utils.io import load_npy, npy_exists


class ExampleBuilder:
    """Builds one (features, label) example per work item.

    Work item: ``[path, trial, length, frame_index_array]`` from the
    arranger.  ``window_length`` is the configured model window; trials
    shorter than it are padded by repeating the last frame — in every split,
    exactly as the reference does (base/dataset.py:555-582).
    """

    def __init__(self,
                 modality: Sequence[str],
                 window_length: int,
                 mean_std: Optional[dict] = None,
                 feature_dimension: Optional[dict] = None,
                 normalized_features: Sequence[str] = (constants.VGGISH,
                                                      constants.BERT),
                 use_native: bool = True,
                 task: str = constants.CLASSIFICATION,
                 continuous_label_dim: Sequence[int] = (0,),
                 host_resize: bool = True):
        self.modality = list(modality)
        self.window_length = window_length
        self.mean_std = mean_std or {}
        self.feature_dimension = feature_dimension or MC.FEATURE_DIMENSION
        self.normalized_features = set(normalized_features)
        self.use_native = use_native
        self.task = task
        self.continuous_label_dim = list(continuous_label_dim)
        # pre-scale raw 256^2 face frames to the transform's SCALE_SIZE on
        # the host: 28x less H2D volume; same antialiased-bilinear kernel
        # as the device transform, uint8-rounded like the reference's
        # GroupScale (see data/host_resize.py)
        self.host_resize = host_resize

    def _gather(self, path: str, length: int, index: np.ndarray,
                feature: str, pad_to: Optional[int] = None,
                center_crop: Optional[int] = None) -> np.ndarray:
        target = self.window_length if pad_to is None else pad_to
        if length < target:
            gather_idx = pad_short_window_indices(length, target)
        else:
            gather_idx = index

        if npy_exists(path, feature):
            filename = os.path.join(path, feature + '.npy')
            if feature == constants.VIDEO and self.host_resize and \
                    npy_exists(path, f'{feature}_{SCALE_SIZE}'):
                # pre-recompacted store (preprocess/recompact.py): the
                # 48^2 frames on disk ARE the resize output — plain rows.
                # Guarded on frame-count equality AND mtime ordering so a
                # stale file (video.npy truncated OR rewritten in place
                # with the same frame count after recompaction) is
                # ignored rather than served.
                small = os.path.join(path,
                                     f'{feature}_{SCALE_SIZE}.npy')
                from fvt_tpu_torch.data import native_store
                try:
                    same = (native_store.npy_header(small)[1][0]
                            == native_store.npy_header(filename)[1][0]
                            and os.path.getmtime(small)
                            >= os.path.getmtime(filename))
                except Exception:
                    same = False
                if same:
                    feature = f'{feature}_{SCALE_SIZE}'
                    filename = small
            data = None
            if self.use_native:
                from fvt_tpu_torch.data import native_store
                if feature == constants.VIDEO and self.host_resize:
                    # fused gather+resize in C (band-limited kernel, no
                    # float frame materialized, GIL released); returns
                    # None for non-256-contract stores -> normal path.
                    # center_crop additionally folds eval's deterministic
                    # 48->40 crop into the resize weights (bit-identical;
                    # see native_store.gather_resize_rows)
                    data = native_store.gather_resize_rows(
                        filename, gather_idx, SCALE_SIZE,
                        crop=center_crop)
                    if data is not None and data.shape[1] in (
                            SCALE_SIZE, center_crop):
                        return data
                data = native_store.gather_rows(filename, gather_idx)
            if data is None:
                data = np.asarray(load_npy(path, feature)[gather_idx])
        else:
            # missing modality file -> zeros (base/dataset.py:606-618)
            shape = (len(gather_idx),) + self.feature_dimension[feature]
            data = np.zeros(shape, dtype=np.float32)
        return data

    def build(self, item, pad_to: Optional[int] = None,
              center_crop: Optional[int] = None) -> Dict[str, np.ndarray]:
        """``pad_to`` overrides the pad-by-repeat target for short trials
        (train-time bucketing, --train_bucketed); None keeps the
        reference's pad-to-window semantics.

        ``center_crop`` (eval only — the crop is deterministic there,
        base/dataset.py:487-539) emits video frames already center-
        cropped from SCALE_SIZE to ``center_crop``: fused into the
        native resize when that path runs, a plain slice otherwise.
        Bit-identical to cropping the SCALE_SIZE output downstream."""
        path, trial, length, index = item
        out: Dict[str, np.ndarray] = {}
        for feature in self.modality:
            data = self._gather(path, length, index, feature, pad_to=pad_to,
                                center_crop=(center_crop if feature ==
                                             constants.VIDEO else None))
            if 'continuous_label' in feature:
                if self.task == constants.REGRESSION:
                    # VA-style continuous labels: (T, D) -> selected dim
                    # (base/dataset.py:621-630)
                    lab = data.astype(np.float32)
                    if lab.ndim > 1:
                        lab = lab[:, self.continuous_label_dim[0]]
                    out[feature] = lab.reshape(-1)
                else:
                    out[feature] = data.astype(np.int32).reshape(-1)
            elif feature == constants.VIDEO and data.ndim == 4:
                if self.host_resize and data.shape[1] not in (
                        SCALE_SIZE, center_crop):
                    from fvt_tpu_torch.data.host_resize import resize_frames_uint8
                    data = resize_frames_uint8(data, SCALE_SIZE)
                if center_crop and data.shape[1] == data.shape[2] == \
                        SCALE_SIZE and 0 < center_crop < SCALE_SIZE:
                    # recompacted-48-store / python-fallback paths: the
                    # crop is a slice here (the native path above already
                    # emitted cropped frames)
                    from fvt_tpu_torch.data.transforms import center_crop_offset
                    off = center_crop_offset(SCALE_SIZE, center_crop)
                    data = np.ascontiguousarray(
                        data[:, off:off + center_crop,
                             off:off + center_crop])
                out[feature] = data  # raw frames; device transform later
            else:
                data = data.astype(np.float32)
                if feature in self.normalized_features \
                        and feature in self.mean_std:
                    avg = self.mean_std[feature]['mean'].astype(np.float32)
                    std = self.mean_std[feature]['std'].astype(np.float32)
                    data = (data - avg) / std
                out[feature] = data
        return out

    def padded_length(self, length: int) -> int:
        """The example's frame count after pad-by-repeat."""
        return max(length, self.window_length)
