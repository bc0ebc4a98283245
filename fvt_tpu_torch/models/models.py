"""LFAN, the leader-follower attention network, eval mode
(``fvt_tpu/models/models.py:73-131``).

The leader is ``modality[0]``.  Each modality runs a TemporalConvNet and
an eval BatchNorm1d; the follower is the multimodal fusion over all of
them; the output is ``concat(feats[leader], follower) @ W + b`` per
frame, with ``tanh`` for regression only.  A ``video`` modality takes
normalised face crops ``(B, T, 40, 40, 3)`` through the frozen ArcFace
backbone at ``spatial.visual``.  Parameter names are those of
``fvt_tpu.models.torch_export.lfan_to_torch``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from fvt_tpu import constants
from fvt_tpu.config import model_config as MC
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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.modality = tuple(modality)
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
            self.spatial.visual = VisualBackbone()
        self.temporal = nn.ModuleDict({
            m: TemporalConvNet(embedding_dim[m], tcn_channel[m], kernel_size)
            for m in self.modality})
        self.bn = nn.ModuleDict({m: nn.BatchNorm1d(encoder_dim[m])
                                 for m in self.modality})
        self.fusion = MultimodalTransformerEncoder(
            self.modality, {m: encoder_dim[m] for m in self.modality},
            modal_dim, num_heads)
        leader_dim = encoder_dim[self.modality[0]]
        self.regressor = nn.Linear(leader_dim + modal_dim * len(modality),
                                   output_dim)
        self.output_dim = output_dim
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
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

    def forward(self, x: Dict[str, torch.Tensor], *,
                reference: bool = False) -> torch.Tensor:
        """x: {modality: (B, T, D)} float32, video as normalised crops
        (B, T, 40, 40, 3).  Returns (B, T, output_dim) logits.
        ``reference=True`` runs the plain versions of the kernels."""
        x = dict(x)
        video = x.get(constants.VIDEO)
        if video is not None and video.dim() == 5:
            b, t = video.shape[:2]
            feats = self.spatial.visual(video.reshape((b * t,)
                                                      + video.shape[2:]))
            x[constants.VIDEO] = feats.reshape(b, t, -1)
        feats = {}
        for m in self.modality:
            h = self.temporal[m](x[m], reference=reference)
            scale, shift = fold_batchnorm(self.bn[m])
            feats[m] = h * scale + shift
        follower = self.fusion(feats, reference=reference)
        out = self.regressor(torch.cat([feats[self.modality[0]], follower],
                                       dim=-1))
        if self.task == constants.REGRESSION:
            out = torch.tanh(out)
        return out
