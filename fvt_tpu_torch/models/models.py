"""The four fusion families of the port (``fvt_tpu/models/models.py``):
LFAN, the leader-follower attention network (``:73-131``), CAN, the gated
attention network (``:134-176``), and JMT and MT, the joint and the plain
multimodal transformer (``:179-231``).  Parameter names are those of
``fvt_tpu.models.torch_export`` (``lfan_to_torch``, ``can_to_torch``,
``jmt_to_torch``) less the dead keys, so upstream weights load as they
are (``from_jax.is_dead_key``).

What the families share (:class:`FusionModel`): each modality runs a
TemporalConvNet and a BatchNorm1d; a ``video`` modality takes normalised
face crops ``(B, T, 40, 40, 3)`` through the frozen ArcFace backbone at
``spatial.visual`` first (``_maybe_encode_spatial``, ``models.py:28-70``),
whose convolution path is the constructor's ``conv_impl`` and
``fused_blocks`` (``conv_impl='int8'`` is ``--serve_quant int8 |
int8_static``) and whose compute type is ``backbone_dtype``
(``torch.bfloat16`` is ``fvt_tpu``'s ``--amp``: the backbone computes in
bfloat16 and returns float32 embeddings; everything after it stays
float32, as there) (or a ready ``spatial_video`` module, as ``fvt_tpu``'s
``init_model(spatial_video=...)`` takes one; it is initialised from
``generator`` with the rest).  A ``logmel`` modality takes raw log-mel
patches ``(B, T, 96, 64)`` through the frozen VGGish at
``spatial.audio.backbone`` (``models/vggish.py``; ``backbone_dtype`` too,
or a ready ``spatial_audio``).  The eval backbones are functions of each
frame (the ArcFace's BatchNorms folded), so an eval forward runs them
over ``eval_frames`` frames at a time: a bucket of whole videos gives the
same embeddings at a bounded memory.  Dynamic int8 and its calibration
are the exception: the per-tensor scale of each conv is the max over
every frame of the call (while calibrating, the outputs still take it, so
every amax after the first conv's depends on the call), so the ArcFace
then runs over all of the forward's frames at once, ``fvt_tpu``'s call
boundary, and a call that may not fit on the card raises
(``VisualBackbone.check_whole_call``); ``whole_calls`` tells the eval pass
to keep its own calls whole too.  Static int8 is a function of each frame
again.

- LFAN: the leader is ``modality[0]``; the follower is the multimodal
  fusion over all modalities; the output is ``concat(feats[leader],
  follower) @ W + b`` per frame.
- CAN: the gating fusion over all modalities (128 each), then ``fc1``,
  BatchNorm ``bn1``, leaky ReLU (0.01) and ``fc2``; TCN dropout 0.2.
- JMT / MT: the transformer fusion of ``video`` and ``vggish``
  (``model_name`` picks the joint one or not), then the head of CAN at
  width 128; ``time_mask`` (B, T) marks the valid frames of a padded
  eval batch.  The TCNs of other modalities run in training, where
  their BatchNorms' running statistics move as in ``fvt_tpu``, and not
  in eval, where nothing reads them.

``tanh`` follows for regression only.

As in ``fvt_tpu``, the mode is the forward's ``train`` argument, not the
module's flag: ``train=True`` runs dropout from an explicit generator,
BatchNorm on batch statistics (updating the running ones) and the
differentiable TCN blocks; ``train=False`` is the serving path through
the eval kernels.  Train mode propagates into the frozen ArcFace, as in
``fvt_tpu``: its BatchNorms run on the batch's statistics and update
their running ones and its Dropout(0.4) is live, though its parameters
get no gradient (it runs under ``torch.no_grad``; its input is data).
``frozen_eval`` (``--frozen_eval_backbones``) runs the backbone's eval
path during training instead: running statistics, no dropout, every eval
route.

The order of the draws from a train step's generator: the video's crop
offsets and flips (``TrainStep``, before the forward), then the
backbone's dropout, then the TCN blocks in modality order (each block's
two masks), then LFAN's fusion.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import model_config as MC
from fvt_tpu_torch.models.arcface import VisualBackbone
from fvt_tpu_torch.models.fusion import (AttentionFusion, JointFusion,
                                         MultimodalTransformerEncoder)
from fvt_tpu_torch.models.layers import fold_batchnorm, init_linear_
from fvt_tpu_torch.models.tcn import TemporalConvNet
from fvt_tpu_torch.models.vggish import VGGish
from fvt_tpu_torch.parallel import collectives

# the TCN of a modality: (input width, channel stack, kernel size)
TCNSpec = Tuple[int, Sequence[int], int]


def batchnorm_frames(bn: nn.BatchNorm1d, h: torch.Tensor,
                     train: bool) -> torch.Tensor:
    """BatchNorm1d over the (B*T, C) view of h (B, T, C).  Train: batch
    statistics, the biased variance to normalise and the unbiased one into
    the running EMA at momentum 0.1 (``fvt_tpu/models/layers.py:79-126``).
    Eval: the running statistics folded to a scale and shift."""
    if not train:
        scale, shift = fold_batchnorm(bn)
        return h * scale + shift
    b, t, c = h.shape
    bn.num_batches_tracked += 1
    if collectives.current() is not None:  # the moments of every rank's rows
        return collectives.batchnorm_frames(bn, h.reshape(b * t, c)
                                            ).reshape(b, t, c)
    return F.batch_norm(h.reshape(b * t, c), bn.running_mean,
                        bn.running_var, bn.weight, bn.bias, True,
                        bn.momentum, bn.eps).reshape(b, t, c)


class FusionModel(nn.Module):
    """The frozen backbone of a ``video`` modality and a TCN + BatchNorm1d
    per modality, which every family runs before its fusion."""

    model_name = ''
    # the eval forward takes the valid frames' ``time_mask`` (JMT, MT), as
    # ``fvt_tpu``'s ``make_eval_step(needs_time_mask=True)``
    needs_time_mask = False

    def __init__(self, modality: Sequence[str], output_dim: int, task: str,
                 tcn: Dict[str, TCNSpec], tcn_dropout: float,
                 conv_impl: str, fused_blocks: bool,
                 backbone_dtype: torch.dtype,
                 spatial_video: Optional[VisualBackbone], frozen_eval: bool,
                 eval_frames: Optional[int],
                 spatial_audio: Optional[VGGish] = None):
        super().__init__()
        self.modality = tuple(modality)
        self.output_dim = output_dim
        self.task = task
        self.frozen_eval = frozen_eval
        self.eval_frames = eval_frames
        if constants.VIDEO in self.modality \
                or constants.LOGMEL in self.modality:
            self.spatial = nn.Module()
        if constants.VIDEO in self.modality:
            self.spatial.visual = spatial_video or VisualBackbone(
                conv_impl, fused_blocks, backbone_dtype)
        if constants.LOGMEL in self.modality:
            self.spatial.audio = nn.Module()
            self.spatial.audio.backbone = spatial_audio or VGGish(
                backbone_dtype)
        self.temporal = nn.ModuleDict({
            m: TemporalConvNet(tcn[m][0], tcn[m][1], tcn[m][2],
                               dropout=tcn_dropout)
            for m in self.modality})
        self.bn = nn.ModuleDict({m: nn.BatchNorm1d(tcn[m][1][-1])
                                 for m in self.modality})

    def reset_temporal(self, generator: torch.Generator) -> None:
        """Random init of the backbone and the TCNs from ``generator``;
        BatchNorms at ones and zeros."""
        if constants.VIDEO in self.modality:
            self.spatial.visual.reset_parameters(generator)
        if constants.LOGMEL in self.modality:
            self.spatial.audio.backbone.reset_parameters(generator)
        for m in self.modality:
            self.temporal[m].reset_parameters(generator)
            self.bn[m].reset_parameters()

    def encode_video(self, x: Dict[str, torch.Tensor], train: bool,
                     generator: Optional[torch.Generator],
                     reference: bool) -> Dict[str, torch.Tensor]:
        """``x`` with raw video crops (B, T, 40, 40, 3) replaced by their
        (B, T, 512) embeddings; features pass as they are.  Train mode
        keeps the whole batch in one pass, since its batch statistics span
        it."""
        video = x.get(constants.VIDEO)
        if video is None or video.dim() != 5:
            return x
        x = dict(x)
        b, t = video.shape[:2]
        frames = video.reshape((b * t,) + video.shape[2:])
        visual = self.spatial.visual
        if train:
            with torch.no_grad():
                feats = visual(frames, reference=reference,
                               train=not self.frozen_eval,
                               generator=generator)
        else:
            n = self.eval_frames or len(frames)
            if self.whole_calls:
                visual.check_whole_call(len(frames), frames.device)
                n = len(frames)
            chunks = [visual(frames[s:s + n], reference=reference)
                      for s in range(0, len(frames), n)]
            feats = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        x[constants.VIDEO] = feats.reshape(b, t, -1)
        return x

    @property
    def whole_calls(self) -> bool:
        """True where an eval forward's output (or the amaxes it records)
        depends on which frames share its call: a ``video`` model under
        dynamic int8 or calibrating."""
        return (constants.VIDEO in self.modality
                and self.spatial.visual.int8_mode() in ('dynamic',
                                                        'calibrating'))

    def encode_logmel(self, x: Dict[str, torch.Tensor], train: bool
                      ) -> Dict[str, torch.Tensor]:
        """``x`` with raw log-mel patches (B, T, 96, 64) replaced by their
        (B, T, 128) VGGish embeddings.  The VGGish has no batch statistics
        and no dropout: train mode runs the eval function under
        ``torch.no_grad`` over the whole batch in one pass, as
        ``fvt_tpu`` does; eval runs it over ``eval_frames`` patches at a
        time."""
        logmel = x.get(constants.LOGMEL)
        if logmel is None or logmel.dim() != 4:
            return x
        x = dict(x)
        b, t = logmel.shape[:2]
        patches = logmel.reshape((b * t,) + logmel.shape[2:])
        vggish = self.spatial.audio.backbone
        if train:
            with torch.no_grad():
                feats = vggish(patches)
        else:
            n = self.eval_frames or len(patches)
            chunks = [vggish(patches[s:s + n])
                      for s in range(0, len(patches), n)]
            feats = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        x[constants.LOGMEL] = feats.reshape(b, t, -1)
        return x

    def encode_spatial(self, x: Dict[str, torch.Tensor], train: bool,
                       generator: Optional[torch.Generator],
                       reference: bool) -> Dict[str, torch.Tensor]:
        """The frozen backbones of ``fvt_tpu``'s ``_maybe_encode_spatial``
        (``models.py:28-70``): raw video through the ArcFace
        (:meth:`encode_video`), raw log-mel patches through the VGGish
        (:meth:`encode_logmel`)."""
        return self.encode_logmel(
            self.encode_video(x, train, generator, reference), train)

    def temporal_features(self, x: Dict[str, torch.Tensor],
                          modalities: Sequence[str], train: bool,
                          generator: Optional[torch.Generator],
                          tcn_fused: bool, reference: bool
                          ) -> Dict[str, torch.Tensor]:
        """Each modality's TCN then BatchNorm: {modality: (B, T, C)}."""
        return {m: batchnorm_frames(
            self.bn[m], self.temporal[m](x[m], train, generator,
                                         fused=tcn_fused,
                                         reference=reference), train)
            for m in modalities}

    def _output(self, out: torch.Tensor) -> torch.Tensor:
        return torch.tanh(out) if self.task == constants.REGRESSION else out


class LFAN(FusionModel):
    model_name = constants.LFAN

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
                 frozen_eval: bool = False,
                 eval_frames: Optional[int] = None,
                 spatial_audio: Optional[VGGish] = None):
        tcn_channel = tcn_channel or MC.TCN_CHANNELS
        embedding_dim = embedding_dim or MC.EMBEDDING_DIM
        encoder_dim = encoder_dim or MC.ENCODER_DIM
        for m in modality:
            if tcn_channel[m][-1] != encoder_dim[m]:
                raise ValueError(f'{m}: TCN output width {tcn_channel[m][-1]}'
                                 f' != encoder_dim {encoder_dim[m]}')
        super().__init__(
            modality, output_dim, task,
            {m: (embedding_dim[m], tcn_channel[m], kernel_size)
             for m in modality}, tcn_dropout, conv_impl, fused_blocks,
            backbone_dtype, spatial_video, frozen_eval, eval_frames,
            spatial_audio)
        self.fusion = MultimodalTransformerEncoder(
            self.modality, {m: encoder_dim[m] for m in self.modality},
            modal_dim, num_heads, dropout=fusion_dropout)
        leader_dim = encoder_dim[self.modality[0]]
        self.regressor = nn.Linear(leader_dim + modal_dim * len(modality),
                                   output_dim)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        # no module reads the flag: the mode is the forward's ``train``
        self.eval()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init drawn from ``generator`` in a fixed module order."""
        self.reset_temporal(generator)
        self.fusion.reset_parameters(generator)
        init_linear_(self.regressor, generator)

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
        x = self.encode_spatial(x, train, generator, reference)
        feats = self.temporal_features(x, self.modality, train, generator,
                                       tcn_fused, reference)
        follower = self.fusion(feats, train, generator, reference=reference)
        return self._output(self.regressor(torch.cat(
            [feats[self.modality[0]], follower], dim=-1)))


class _HeadModel(FusionModel):
    """CAN's and JMT's head: ``fc1``, BatchNorm ``bn1``, leaky ReLU (0.01),
    ``fc2``; TCN settings per modality (``config/model_config.py``
    ``TCN_SETTINGS``), TCN dropout 0.2 by default."""

    def __init__(self, modality: Sequence[str], output_dim: int, task: str,
                 tcn_settings: Optional[Dict[str, dict]],
                 tcn_dropout: float, conv_impl: str, fused_blocks: bool,
                 backbone_dtype: torch.dtype,
                 spatial_video: Optional[VisualBackbone], frozen_eval: bool,
                 eval_frames: Optional[int],
                 spatial_audio: Optional[VGGish]):
        settings = tcn_settings or MC.TCN_SETTINGS
        super().__init__(
            modality, output_dim, task,
            {m: (settings[m]['input_dim'], settings[m]['channel'],
                 settings[m]['kernel_size']) for m in modality},
            tcn_dropout, conv_impl, fused_blocks, backbone_dtype,
            spatial_video, frozen_eval, eval_frames, spatial_audio)

    def build_head(self, width: int,
                   generator: Optional[torch.Generator]) -> None:
        self.fc1 = nn.Linear(width, width)
        self.bn1 = nn.BatchNorm1d(width)
        self.fc2 = nn.Linear(width, self.output_dim)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        # no module reads the flag: the mode is the forward's ``train``
        self.eval()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init drawn from ``generator`` in a fixed module order."""
        self.reset_temporal(generator)
        self.fuse.reset_parameters(generator)
        init_linear_(self.fc1, generator)
        self.bn1.reset_parameters()
        init_linear_(self.fc2, generator)

    def head(self, c: torch.Tensor, train: bool) -> torch.Tensor:
        c = batchnorm_frames(self.bn1, self.fc1(c), train)
        return self._output(self.fc2(F.leaky_relu(c, 0.01)))


class CAN(_HeadModel):
    model_name = constants.CAN

    def __init__(self, modality: Sequence[str], output_dim: int,
                 task: str = constants.CLASSIFICATION,
                 tcn_settings: Optional[Dict[str, dict]] = None,
                 tcn_dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None,
                 conv_impl: str = 'cudnn', fused_blocks: bool = False,
                 backbone_dtype: torch.dtype = torch.float32,
                 spatial_video: Optional[VisualBackbone] = None,
                 frozen_eval: bool = False,
                 eval_frames: Optional[int] = None,
                 spatial_audio: Optional[VGGish] = None):
        super().__init__(modality, output_dim, task, tcn_settings,
                         tcn_dropout, conv_impl, fused_blocks,
                         backbone_dtype, spatial_video, frozen_eval,
                         eval_frames, spatial_audio)
        self.fuse = AttentionFusion(
            [self.bn[m].num_features for m in self.modality], 128)
        self.build_head(self.fuse.weights.out_features, generator)

    def forward(self, x: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None, *,
                tcn_fused: bool = True,
                reference: bool = False) -> torch.Tensor:
        """As :meth:`LFAN.forward`."""
        x = self.encode_spatial(x, train, generator, reference)
        feats = self.temporal_features(x, self.modality, train, generator,
                                       tcn_fused, reference)
        return self.head(self.fuse([feats[m] for m in self.modality]),
                         train)


class JMT(_HeadModel):
    """JMT, or MT with ``model_name='MT'``; needs ``video`` and
    ``vggish``."""

    FUSED = (constants.VIDEO, constants.VGGISH)
    needs_time_mask = True

    def __init__(self, modality: Sequence[str], output_dim: int,
                 model_name: str = constants.JMT,
                 task: str = constants.CLASSIFICATION,
                 tcn_settings: Optional[Dict[str, dict]] = None,
                 tcn_dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None,
                 conv_impl: str = 'cudnn', fused_blocks: bool = False,
                 backbone_dtype: torch.dtype = torch.float32,
                 spatial_video: Optional[VisualBackbone] = None,
                 frozen_eval: bool = False,
                 eval_frames: Optional[int] = None,
                 spatial_audio: Optional[VGGish] = None):
        if model_name not in (constants.JMT, constants.MT):
            raise ValueError(f'{model_name} is neither JMT nor MT')
        missing = set(self.FUSED) - set(modality)
        if missing:
            raise ValueError(f'{model_name} fuses {self.FUSED}: '
                             f'{sorted(missing)} missing from {modality}')
        super().__init__(modality, output_dim, task, tcn_settings,
                         tcn_dropout, conv_impl, fused_blocks,
                         backbone_dtype, spatial_video, frozen_eval,
                         eval_frames, spatial_audio)
        self.model_name = model_name
        self.fuse = JointFusion(self.bn[constants.VGGISH].num_features,
                                joint=model_name == constants.JMT)
        self.build_head(JointFusion.DIM, generator)

    def forward(self, x: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None, *,
                tcn_fused: bool = True, reference: bool = False,
                time_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """As :meth:`LFAN.forward`; ``time_mask`` (B, T) bool marks the
        valid frames (``fvt_tpu``'s eval passes it, its training not)."""
        x = self.encode_spatial(x, train, generator, reference)
        feats = self.temporal_features(
            x, self.modality if train else self.FUSED, train, generator,
            tcn_fused, reference)
        return self.head(self.fuse(feats[constants.VIDEO],
                                   feats[constants.VGGISH],
                                   time_mask), train)
