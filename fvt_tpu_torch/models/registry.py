"""Model factory of the port (``fvt_tpu/models/registry.py``,
``experiment.py:166-188``): the model a run's config names, LFAN, CAN,
JMT or MT.

A ``video`` modality gets the frozen ArcFace, a ``logmel`` one the frozen
VGGish (``experiment.py:166-188``).  ``--amp`` builds both backbones in
bfloat16, as ``fvt_tpu`` does; the convolutions run on cuDNN, as
``fvt_tpu``'s CLI runs XLA's, except under ``--serve_quant int8`` or
``int8_static``, which build the ArcFace with ``conv_impl='int8'``
(``experiment.py:174-182``): its convs of 128 input channels or more on
the int8 kernels (``ops/quant.py``).  ``--frozen_eval_backbones`` runs the
frozen ArcFace in eval mode during training (``frozen_eval=True``; the
VGGish has one mode).  An eval forward runs a backbone over
``eval_window_batch * window_length`` frames at a time, the most an LFAN
window batch gives it, so a bucket of whole videos (CAN, JMT, MT) fits
the card too.
``--pallas_train`` is accepted and changes nothing: the port trains
through its fused TCN train kernel on every modality
(``Trainer(tcn_fused=True)``), where ``fvt_tpu`` turns its Pallas train
kernel off for backbone modalities on a TPU measurement and runs CAN, JMT
and MT on its plain TCN.  ``--pallas_serving`` is accepted and changes
nothing: the port's eval runs the fused TCN kernel, and LFAN's fusion
kernel, on the card in any case.
"""
from __future__ import annotations

from typing import Optional

import torch

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import model_config as MC
from fvt_tpu_torch.models.models import CAN, JMT, LFAN, FusionModel


QUANT_MODES = ('none', 'int8', 'int8_static')


def split_modality(modality_str: str) -> list:
    """'video+vggish+bert+EXPR_continuous_label' -> the model's modality
    list (the label stream removed)."""
    return [m for m in modality_str.split('+')
            if 'continuous_label' not in m]


def init_model(args, generator: Optional[torch.Generator] = None
               ) -> FusionModel:
    """The model of ``args`` (a config namespace), its weights drawn from
    ``generator`` (seeded from ``args.seed`` by default), on the CPU."""
    name = args.model_name
    if name not in constants.FUSION_METHODS:
        raise NotImplementedError(name)
    quant = getattr(args, 'serve_quant', 'none') or 'none'
    if quant not in QUANT_MODES:
        raise ValueError(f'--serve_quant {quant}: one of {QUANT_MODES}')
    modality = tuple(split_modality(args.modality))
    num_classes = args.num_classes
    if args.dataset_name == constants.C_EXPR_DB and args.use_other_class:
        num_classes += 1
    if generator is None:
        generator = torch.Generator().manual_seed(int(args.seed))
    kw = dict(output_dim=num_classes, task=args.task, generator=generator,
              conv_impl='int8' if quant != 'none' else 'cudnn',
              backbone_dtype=(torch.bfloat16 if getattr(args, 'amp', False)
                              else torch.float32),
              frozen_eval=getattr(args, 'frozen_eval_backbones', False),
              eval_frames=(int(getattr(args, 'eval_window_batch', 8) or 8)
                           * int(args.window_length)))
    if name == constants.LFAN:
        return LFAN(modality, kernel_size=args.tcn_kernel_size,
                    tcn_channel=MC.TCN_CHANNELS, modal_dim=args.modal_dim,
                    num_heads=args.num_heads, **kw)
    if name == constants.CAN:
        return CAN(modality, tcn_settings=MC.TCN_SETTINGS, **kw)
    return JMT(modality, model_name=name, tcn_settings=MC.TCN_SETTINGS,
               **kw)
