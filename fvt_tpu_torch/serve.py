"""The eval forward of the port (counterpart of ``fvt_tpu/serve.py`` and
of ``make_eval_step``, ``fvt_tpu/train/steps.py:167-196``).

:func:`serving_forward` is the eval step of every family: the eval video
transform, the frozen ArcFace backbone, one TemporalConvNet per modality
through the fused TCN-block kernel, the folded eval BatchNorm, then the
family's fusion and head (LFAN's fusion through the fused fusion
kernel); JMT and MT take the valid frames' ``time_mask``.
:func:`lfan_serving_forward` is the LFAN's.  :func:`calibrate_act_scales`
records the int8 ArcFace's activation scales (``--serve_quant
int8_static``) through it.

:class:`ServingModel` wraps a model of any family at fixed ``(window_batch,
seq_len)`` shapes behind the interface of an ``fvt_tpu`` serving
artifact: ``.meta`` with ``fvt_tpu/export.py``'s keys, the inputs of
:func:`serving_input_specs` and ``.call(inputs, length=None)`` on numpy
arrays, routed by (B, T).  So the server core of
``fvt_tpu_torch.streaming`` (``StreamingSession``, ``StreamingRegistry``,
``WindowBatcher``), a copy of ``fvt_tpu.streaming``, serves it, and
``fvt_tpu_torch.export.ServingArtifact`` is one loaded from a file.

A model built with ``backbone_dtype=torch.bfloat16`` (``--amp`` in
``fvt_tpu``) is served as it is: its parameters stay float32 on the device,
only its backbone computes in bfloat16, and the specs and outputs do not
change (uint8 crops and float32 features in, float32 logits out).
``bf16_features`` (``--h2d_bf16_features``) takes the feature streams in
bfloat16, as ``fvt_tpu``'s specs say: a float32 array is rounded on the
host as ``ml_dtypes`` rounds, raw bits (uint16) or an ``ml_dtypes`` array
are taken as they are (``utils/bf16.py``), two bytes a value cross to the
device and :func:`serving_forward` widens them to float32 there, as
``fvt_tpu``'s ``_device_transform`` does.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import model_config as MC
from fvt_tpu_torch.data.transforms import (CROP_SIZE, SCALE_SIZE,
                                           eval_video_transform)
from fvt_tpu_torch.models.models import LFAN, FusionModel
from fvt_tpu_torch.utils import bf16


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
    the kernels (for checks and tests).  bfloat16 feature streams are
    widened to float32."""
    x = {k: v.float() if v.dtype == torch.bfloat16 else v
         for k, v in batch.items()}
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


def calibrate_act_scales(model: FusionModel, sample_batch: dict,
                         device=None, reference: bool = False) -> dict:
    """``fvt_tpu``'s ``calibrate_act_scales`` (``fvt_tpu/ops/quant.py:
    161-172``): the model's eval forward over one representative batch
    (numpy, its label streams dropped) with every quantised conv recording
    its running ``max|x|``; returns the ``act_scales`` tree under
    ``fvt_tpu``'s paths (``{'spatial_video': {'backbone': {'body<i>':
    {'conv<j>': {'amax': ...}}}}}``, numpy float32 scalars) and leaves the
    model serving with them (static).  While recording, each conv's output
    takes the call's own scale, so the backbone runs over all of the
    batch's frames in one call, as ``fvt_tpu``'s one apply does
    (``FusionModel.whole_calls``).  Raises if no conv recorded one (a
    backbone without ``conv_impl='int8'``).  Shared by
    ``Trainer.calibrate_quant`` and the export tool, as in ``fvt_tpu``.
    ``reference=True`` runs the plain versions of the kernels."""
    visual = getattr(getattr(model, 'spatial', None), 'visual', None)
    if visual is None or not visual.int8_convs():
        raise ValueError(
            'calibration recorded no activation scales — is the backbone '
            'running with conv_impl=int8 (serve_quant int8/int8_static)?')
    dev = device or next(model.parameters()).device
    inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in sample_batch.items()
              if 'continuous_label' not in k}
    visual.begin_calibration()
    try:
        serving_forward(model, inputs, reference=reference)
    finally:
        visual.end_calibration()
    return {'spatial_video': visual.act_scales()}


def shape_key(window_batch: int, seq_len: int) -> str:
    """``fvt_tpu/export.py``'s key of a served ``(B, T)`` shape."""
    return f'b{int(window_batch)}xt{int(seq_len)}'


def serving_input_specs(modality: Sequence[str], window_batch: int,
                        seq_len: int, precrop_video: bool = True,
                        bf16_features: bool = False) -> dict:
    """One served batch's inputs as ``fvt_tpu/export.py:75-97``'s
    ``serving_input_specs`` gives them: video as uint8 crops of
    ``CROP_SIZE`` (``h2d_precrop_video``, the default) or frames of
    ``SCALE_SIZE`` (the eval transform crops them), raw (96, 64) log-mel
    patches and the other features as float32, or bfloat16 with
    ``bf16_features``.  {modality: {'shape', 'dtype'}}, as
    ``meta['shapes'][key]['inputs']`` holds them."""
    wb, t = int(window_batch), int(seq_len)
    specs = {}
    for m in modality:
        if m == constants.VIDEO:
            s = CROP_SIZE if precrop_video else SCALE_SIZE
            shape, dtype = (wb, t, s, s, 3), 'uint8'
        else:
            shape = (wb, t) + tuple(MC.FEATURE_DIMENSION[m])
            dtype = bf16.BF16 if bf16_features else 'float32'
        specs[m] = {'shape': list(shape), 'dtype': dtype}
    return specs


class ServingModel:
    """A model of any family on ``device`` served at fixed ``(window_batch,
    seq_len)`` shapes, behind the interface of an ``fvt_tpu`` serving
    artifact: ``meta`` (``model_name``, ``modality``, ``num_classes``,
    ``needs_mask``, ``window_length``, ``hop_length``, ``shapes``),
    ``shape_keys`` and ``call(inputs, length=None)`` on numpy arrays, routed
    by their (B, T).  ``shapes`` defaults to the one ``(window_batch,
    window_length)``.  JMT and MT (``needs_mask``) take a (B,) ``length``
    of valid frames, the full T when it is None; LFAN and CAN refuse
    one.  ``bf16_features``: the module docstring."""

    def __init__(self, model: FusionModel, window_batch: Optional[int],
                 window_length: int, hop_length: int, device, *,
                 shapes: Optional[Sequence[Tuple[int, int]]] = None,
                 precrop_video: bool = True, bf16_features: bool = False):
        self.model = model.to(device).eval()
        self.device = torch.device(device)
        self.needs_mask = bool(model.needs_time_mask)
        # one forward at a time: a server's request threads share the
        # card, and a sharded call's collectives run in one order on every
        # rank (parallel/serving.py)
        self._lock = threading.Lock()
        shapes = shapes or [(window_batch, window_length)]
        self.shape_specs = {
            shape_key(wb, t): serving_input_specs(model.modality, wb, t,
                                                  precrop_video,
                                                  bf16_features)
            for wb, t in shapes}
        # the first shape's, which a single-shape server is served at
        self.specs = self.shape_specs[shape_key(*shapes[0])]
        self.meta = {
            'model_name': model.model_name,
            'modality': '+'.join(model.modality),
            'num_classes': model.output_dim,
            'needs_mask': self.needs_mask,
            'window_length': int(window_length),
            'hop_length': int(hop_length),
            'shapes': {shape_key(wb, t): {
                'window_batch': int(wb), 'seq_len': int(t),
                'inputs': self.shape_specs[shape_key(wb, t)]}
                for wb, t in shapes},
        }

    @property
    def shape_keys(self) -> List[str]:
        return sorted(self.shape_specs)

    def route(self, inputs: Dict[str, np.ndarray]) -> str:
        """The key of the shape that ``inputs``' (B, T) is served at, else
        KeyError naming the shapes there are."""
        b, t = np.shape(next(iter(inputs.values())))[:2]
        key = shape_key(b, t)
        if key not in self.shape_specs:
            raise KeyError(f'no served shape for batch shape ({b}, {t}); '
                           f'served: {self.shape_keys} - export this shape '
                           f'or pad the batch to one of them')
        return key

    def host_inputs(self, inputs: Dict[str, np.ndarray],
                    length: Optional[np.ndarray] = None
                    ) -> Tuple[str, Dict[str, np.ndarray],
                               Optional[np.ndarray]]:
        """(the key of the shape ``inputs`` is served at, the arrays as
        they cross to the device (a bfloat16 input as its bits, uint16),
        the (B,) int64 valid frames of a JMT or MT, the full T where
        ``length`` is None, else None); raises, naming the input, where
        :meth:`call` refuses it."""
        if length is not None and not self.needs_mask:
            raise ValueError(f'{self.meta["model_name"]} takes no time mask '
                             f'(needs_mask=False)')
        key = self.route(inputs)
        specs = self.shape_specs[key]
        if set(inputs) != set(specs):
            raise ValueError(f'expected inputs {sorted(specs)}, got '
                             f'{sorted(inputs)}')
        arrays = {}
        for k, spec in specs.items():
            a = np.asarray(inputs[k])
            half = spec['dtype'] == bf16.BF16 and (
                a.dtype in (np.float32, np.uint16)
                or a.dtype.name == bf16.BF16)
            if list(a.shape) != spec['shape'] or not (
                    half or a.dtype == spec['dtype']):
                raise ValueError(f'{k}: expected {spec["dtype"]} '
                                 f'{spec["shape"]}, got {a.dtype} '
                                 f'{list(a.shape)}')
            arrays[k] = bf16.as_bits(a) if half else a
        lengths = None
        if self.needs_mask:
            b, t = specs[next(iter(specs))]['shape'][:2]
            lengths = np.array(np.broadcast_to(np.asarray(
                t if length is None else length, np.int64), (b,)))
        return key, arrays, lengths

    def call(self, inputs: Dict[str, np.ndarray],
             length: Optional[np.ndarray] = None) -> np.ndarray:
        """(B, T, C) float32 numpy logits of one batch of exactly the
        shapes and dtypes of ``meta['shapes'][key]['inputs']`` (a
        bfloat16 input as the module docstring says)."""
        key, arrays, lengths = self.host_inputs(inputs, length)
        specs = self.shape_specs[key]
        batch = {k: (bf16.to_device(a, self.device)
                     if specs[k]['dtype'] == bf16.BF16
                     else torch.from_numpy(a).to(self.device))
                 for k, a in arrays.items()}
        time_mask = None
        if lengths is not None:
            time_mask = valid_frames(lengths, specs[next(iter(specs))]
                                     ['shape'][1], self.device)
        with self._lock:
            out = serving_forward(self.model, batch, time_mask=time_mask)
            return out.cpu().numpy()
