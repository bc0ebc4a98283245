"""The eval forward of the port (counterpart of ``fvt_tpu/serve.py`` and
of ``make_eval_step``, ``fvt_tpu/train/steps.py:167-196``).

:func:`serving_forward` is the eval step of every family: the eval video
transform, the frozen ArcFace backbone, one TemporalConvNet per modality
through the fused TCN-block kernel, the folded eval BatchNorm, then the
family's fusion and head (LFAN's fusion through the fused fusion
kernel); JMT and MT take the valid frames' ``time_mask``.
:func:`lfan_serving_forward` is the LFAN's, which :class:`ServingModel`
serves.

:class:`ServingModel` wraps a model at one ``(window_batch,
window_length)`` shape behind the interface of an ``fvt_tpu`` serving
artifact: ``.meta`` with ``fvt_tpu/export.py``'s keys and
``.call(inputs, length=None)`` on numpy arrays.  So the server core of
``fvt_tpu_torch.streaming`` (``StreamingSession``, ``StreamingRegistry``,
``WindowBatcher``), a copy of ``fvt_tpu.streaming``, serves it.

A model built with ``backbone_dtype=torch.bfloat16`` (``--amp`` in
``fvt_tpu``) is served as it is: its parameters stay float32 on the device,
only its backbone computes in bfloat16, and the specs and outputs do not
change (uint8 crops and float32 features in, float32 logits out).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import model_config as MC
from fvt_tpu_torch.data.transforms import CROP_SIZE, eval_video_transform
from fvt_tpu_torch.models.models import LFAN, FusionModel


def valid_frames(lengths, t: int, device) -> torch.Tensor:
    """(B, t) bool, True on the first ``lengths[b]`` frames of row b."""
    lengths = torch.as_tensor(lengths, device=device).reshape(-1, 1)
    return torch.arange(t, device=device)[None, :] < lengths


def serving_forward(model: FusionModel, batch: Dict[str, torch.Tensor], *,
                    time_mask: Optional[torch.Tensor] = None,
                    reference: bool = False) -> torch.Tensor:
    """batch: {modality: (B, T, ...)} on the model's device, video as
    uint8 crops.  Returns (B, T, C) float32 logits.  ``time_mask`` (B, T)
    goes to a JMT or MT.  ``reference=True`` runs the plain versions of
    the kernels (for checks and tests)."""
    x = dict(batch)
    video = x.get(constants.VIDEO)
    if video is not None and video.dtype == torch.uint8:
        x[constants.VIDEO] = eval_video_transform(video)
    kw = {} if time_mask is None else {'time_mask': time_mask}
    with torch.inference_mode():
        return model(x, reference=reference, **kw)


def lfan_serving_forward(model: LFAN, batch: Dict[str, torch.Tensor], *,
                         reference: bool = False) -> torch.Tensor:
    """:func:`serving_forward` of an LFAN, which takes no mask."""
    return serving_forward(model, batch, reference=reference)


class ServingModel:
    """An LFAN on ``device`` served at one ``(window_batch,
    window_length)`` shape.  ``call`` takes numpy inputs of exactly the
    shapes and dtypes in ``meta['shapes']`` and returns (wb, T, C) numpy
    logits."""

    def __init__(self, model: LFAN, window_batch: int, window_length: int,
                 hop_length: int, device):
        self.model = model.to(device).eval()
        self.device = torch.device(device)
        wb, t = int(window_batch), int(window_length)
        # one batch's inputs as fvt_tpu.export.serving_input_specs gives
        # them: video as uint8 40^2 crops, features as float32
        self.specs = {}
        for m in model.modality:
            if m == constants.VIDEO:
                shape, dtype = (wb, t, CROP_SIZE, CROP_SIZE, 3), 'uint8'
            else:
                shape = (wb, t) + tuple(MC.FEATURE_DIMENSION[m])
                dtype = 'float32'
            self.specs[m] = {'shape': list(shape), 'dtype': dtype}
        self.meta = {
            'model_name': constants.LFAN,
            'modality': '+'.join(model.modality),
            'num_classes': model.output_dim,
            'needs_mask': False,
            'window_length': t,
            'hop_length': int(hop_length),
            'shapes': {f'b{wb}xt{t}': {'window_batch': wb, 'seq_len': t,
                                       'inputs': self.specs}},
        }

    def call(self, inputs: Dict[str, np.ndarray],
             length: Optional[np.ndarray] = None) -> np.ndarray:
        if length is not None:
            raise ValueError('LFAN takes no time mask (needs_mask=False)')
        if set(inputs) != set(self.specs):
            raise ValueError(f'expected inputs {sorted(self.specs)}, got '
                             f'{sorted(inputs)}')
        batch = {}
        for k, spec in self.specs.items():
            a = np.asarray(inputs[k])
            if list(a.shape) != spec['shape'] or a.dtype != spec['dtype']:
                raise ValueError(f'{k}: expected {spec["dtype"]} '
                                 f'{spec["shape"]}, got {a.dtype} '
                                 f'{list(a.shape)}')
            batch[k] = torch.from_numpy(a).to(self.device)
        out = lfan_serving_forward(self.model, batch)
        return out.cpu().numpy()
