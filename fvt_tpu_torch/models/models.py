"""LFAN, the leader-follower attention network
(``fvt_tpu/models/models.py:73-131``).

The leader is ``modality[0]``.  Each modality runs a TemporalConvNet and
a BatchNorm1d; the follower is the multimodal fusion over all of them;
the output is ``concat(feats[leader], follower) @ W + b`` per frame, with
``tanh`` for regression only.  A ``video`` modality takes normalised face
crops ``(B, T, 40, 40, 3)`` through the frozen ArcFace backbone at
``spatial.visual``, whose convolution path is the constructor's
``conv_impl`` and ``fused_blocks`` and whose compute type is
``backbone_dtype`` (``torch.bfloat16`` is ``fvt_tpu``'s ``--amp``: the
backbone computes in bfloat16 and returns float32 embeddings; everything
after it stays float32, as there) (or a ready ``spatial_video`` module,
as ``fvt_tpu``'s ``init_model(spatial_video=...)`` takes one; it is
initialised from ``generator`` with the rest).  Parameter
names are those of ``fvt_tpu.models.torch_export.lfan_to_torch``.

As in ``fvt_tpu``, the mode is the forward's ``train`` argument, not the
module's flag: ``train=True`` runs dropout from an explicit generator,
BatchNorm on batch statistics (updating the running ones) and the
differentiable TCN blocks; ``train=False`` is the serving path through
the eval kernels.  Train mode propagates into the frozen ArcFace, as in
``fvt_tpu`` (``models.py:28-67``): its BatchNorms run on the batch's
statistics and update their running ones and its Dropout(0.4) is live,
though its parameters get no gradient (it runs under ``torch.no_grad``;
its input is data).  ``frozen_eval`` (``--frozen_eval_backbones``) runs
the backbone's eval path during training instead: running statistics, no
dropout, every eval route.

The order of the draws from a train step's generator: the video's crop
offsets and flips (``TrainStep``, before the forward), then the
backbone's dropout, then the TCN blocks in modality order (each block's
two masks), then the fusion.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import model_config as MC
from fvt_tpu_torch.models.arcface import VisualBackbone
from fvt_tpu_torch.models.fusion import MultimodalTransformerEncoder
from fvt_tpu_torch.models.layers import fold_batchnorm, init_linear_
from fvt_tpu_torch.models.tcn import TemporalConvNet


class LFAN(nn.Module):
    def __init__(self, modality: Sequence[str], output_dim: int,
                 task: str = constants.CLASSIFICATION,
                 kernel_size: int = MC.TCN_KERNEL_SIZE,
                 tcn_channel: Optional[Dict[str, Sequence[int]]] = None,
                 embedding_dim: Optional[Dict[str, int]] = None,
                 encoder_dim: Optional[Dict[str, int]] = None,
                 modal_dim: int = 32, num_heads: int = 2,
                 tcn_dropout: float = 0.1, fusion_dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 conv_impl: str = 'cudnn', fused_blocks: bool = False,
                 backbone_dtype: torch.dtype = torch.float32,
                 spatial_video: Optional[VisualBackbone] = None,
                 frozen_eval: bool = False):
        super().__init__()
        self.modality = tuple(modality)
        self.frozen_eval = frozen_eval
        self.task = task
        tcn_channel = tcn_channel or MC.TCN_CHANNELS
        embedding_dim = embedding_dim or MC.EMBEDDING_DIM
        encoder_dim = encoder_dim or MC.ENCODER_DIM
        for m in self.modality:
            if tcn_channel[m][-1] != encoder_dim[m]:
                raise ValueError(f'{m}: TCN output width {tcn_channel[m][-1]}'
                                 f' != encoder_dim {encoder_dim[m]}')
        if constants.VIDEO in self.modality:
            self.spatial = nn.Module()
            self.spatial.visual = spatial_video or VisualBackbone(
                conv_impl, fused_blocks, backbone_dtype)
        self.temporal = nn.ModuleDict({
            m: TemporalConvNet(embedding_dim[m], tcn_channel[m], kernel_size,
                               dropout=tcn_dropout)
            for m in self.modality})
        self.bn = nn.ModuleDict({m: nn.BatchNorm1d(encoder_dim[m])
                                 for m in self.modality})
        self.fusion = MultimodalTransformerEncoder(
            self.modality, {m: encoder_dim[m] for m in self.modality},
            modal_dim, num_heads, dropout=fusion_dropout)
        leader_dim = encoder_dim[self.modality[0]]
        self.regressor = nn.Linear(leader_dim + modal_dim * len(modality),
                                   output_dim)
        self.output_dim = output_dim
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        # no module reads the flag: the mode is the forward's ``train``
        self.eval()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init drawn from ``generator`` in a fixed module order."""
        if hasattr(self, 'spatial'):
            self.spatial.visual.reset_parameters(generator)
        for m in self.modality:
            self.temporal[m].reset_parameters(generator)
            self.bn[m].reset_parameters()
        self.fusion.reset_parameters(generator)
        init_linear_(self.regressor, generator)

    def _batchnorm_train(self, m: str, h: torch.Tensor) -> torch.Tensor:
        """BatchNorm1d over the (B*T, C) view on batch statistics: biased
        variance to normalise, the unbiased one into the running EMA at
        momentum 0.1 (``fvt_tpu/models/layers.py:79-126``)."""
        bn = self.bn[m]
        b, t, c = h.shape
        bn.num_batches_tracked += 1
        return F.batch_norm(h.reshape(b * t, c), bn.running_mean,
                            bn.running_var, bn.weight, bn.bias, True,
                            bn.momentum, bn.eps).reshape(b, t, c)

    def forward(self, x: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None, *,
                tcn_fused: bool = True,
                reference: bool = False) -> torch.Tensor:
        """x: {modality: (B, T, D)} float32, video as normalised crops
        (B, T, 40, 40, 3).  Returns (B, T, output_dim) logits.
        ``train=True`` draws the dropout masks from ``generator`` (the
        backbone's, the TCN blocks' in modality order, then the fusion's)
        and updates the BatchNorm running statistics, the backbone's
        unless ``frozen_eval``; ``tcn_fused`` picks the fused train kernel
        over the conv-by-conv blocks.  ``reference=True`` runs the plain
        versions of the kernels."""
        x = dict(x)
        video = x.get(constants.VIDEO)
        if video is not None and video.dim() == 5:
            b, t = video.shape[:2]
            frames = video.reshape((b * t,) + video.shape[2:])
            if train:
                with torch.no_grad():
                    feats = self.spatial.visual(
                        frames, reference=reference,
                        train=not self.frozen_eval, generator=generator)
            else:
                feats = self.spatial.visual(frames, reference=reference)
            x[constants.VIDEO] = feats.reshape(b, t, -1)
        feats = {}
        for m in self.modality:
            h = self.temporal[m](x[m], train, generator, fused=tcn_fused,
                                 reference=reference)
            if train:
                feats[m] = self._batchnorm_train(m, h)
            else:
                scale, shift = fold_batchnorm(self.bn[m])
                feats[m] = h * scale + shift
        follower = self.fusion(feats, train, generator, reference=reference)
        out = self.regressor(torch.cat([feats[self.modality[0]], follower],
                                       dim=-1))
        if self.task == constants.REGRESSION:
            out = torch.tanh(out)
        return out
