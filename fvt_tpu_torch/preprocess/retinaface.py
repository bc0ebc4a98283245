"""RetinaFace-ResNet50 face detector on the card; the port of
``fvt_tpu/preprocess/retinaface.py``.

The upstream's preprocessing hinges on the ternaus ``retinaface``
package (RetinaFace-R50, retinaface_align.py:64-284).  This module holds
the whole inference network as an ``nn.Module`` under the ternaus names,
so that the published ``retinaface_resnet50_2020-07-20.pth`` loads with
``strict=True`` (keys and shapes: :func:`expected_state_dict_shapes`,
``fvt_tpu``'s contract):

  * a torchvision-named ResNet-50 trunk (the stride on ``conv2``, the
    max-pool padded with -inf) -> C3/C4/C5, no torchvision needed;
  * FPN (256 ch) + SSH context modules on 3 levels; the FPN upsample is
    ``F.interpolate(mode='nearest-exact')``, half-pixel centres as
    ``fvt_tpu``'s ``jax.image.resize(..., 'nearest')`` (the upstream's
    legacy ``'nearest'`` differs where the sizes are not multiples of
    32, that is where ``max_size`` is not);
  * 2-anchor class/bbox/landmark heads per level, the scores softmaxed;
  * on the host, ``fvt_tpu``'s prior boxes, variance decode, greedy NMS
    and the ternaus ``predict_jsons`` integer post-processing, copied.

:class:`RetinaFaceR50` is the detector (``fvt_tpu``'s ``RetinaFaceJAX``):
the longest-side resize to ``max_size`` (the antialiased triangle of
``data/host_resize.resize_weights`` as two float32 products with TF32 off),
the rounding to uint8, the ImageNet normalisation and the centre pad run
on ``device`` (None: the card), one frame a forward; only the score
column comes to the host, and the kept rows are gathered on the card.
The convolutions run in float32 with TF32 off whatever the caller set.
"""
from __future__ import annotations

import math
import os
from itertools import product
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fvt_tpu_torch.data.host_resize import resize_weights
from fvt_tpu_torch.preprocess.melspec import no_tf32
from fvt_tpu_torch.train.steps import resolve_device

# ternaus cfg_re50 (retinaface/network.py)
MIN_SIZES = [[16, 32], [64, 128], [256, 512]]
STEPS = [8, 16, 32]
VARIANCES = (0.1, 0.2)
FPN_CH = 256
# albumentations Normalize defaults (ImageNet)
NORM_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
NORM_STD = np.array([0.229, 0.224, 0.225], np.float32)
# torchvision resnet50: (planes, blocks, stride) of layer1..layer4
RESNET50_LAYERS = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
# (name, in channels, out channels) of an SSH module's five conv+BN
SSH_CONVS = (('conv3X3', FPN_CH, FPN_CH // 2),
             ('conv5X5_1', FPN_CH, FPN_CH // 4),
             ('conv5X5_2', FPN_CH // 4, FPN_CH // 4),
             ('conv7X7_2', FPN_CH // 4, FPN_CH // 4),
             ('conv7x7_3', FPN_CH // 4, FPN_CH // 4))
# (upstream name, outputs per anchor) of the three heads
HEADS = (('BboxHead', 4), ('ClassHead', 2), ('LandmarkHead', 10))


# ------------------------------------------------------------------ layers
def conv_bn(cin: int, cout: int, kernel: int) -> nn.Sequential:
    """conv + BN: the ``0`` and ``1`` of retinaface/network.py's
    conv_bn / conv_bn1X1 / conv_bn_no_relu (their LeakyReLU, slope 0 at
    256 channels, is applied by the caller)."""
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, padding=kernel // 2,
                                   bias=False), nn.BatchNorm2d(cout))


class Bottleneck(nn.Module):
    """torchvision ResNet Bottleneck (1x1 -> 3x3 -> 1x1, expansion 4)."""

    def __init__(self, cin: int, planes: int, stride: int,
                 downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Body(nn.Module):
    """torchvision resnet50 up to layer4, returning (C3, C4, C5) = the
    outputs of (layer2, layer3, layer4): the IntermediateLayerGetter of
    retinaface/network.py."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for li, (planes, blocks, stride) in enumerate(RESNET50_LAYERS):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, planes, stride if b == 0 else 1,
                                        downsample=b == 0))
                cin = planes * 4
            setattr(self, f'layer{li + 1}', nn.Sequential(*layer))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)  # pads with -inf
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


class FPN(nn.Module):
    def __init__(self):
        super().__init__()
        self.output1 = conv_bn(512, FPN_CH, 1)
        self.output2 = conv_bn(1024, FPN_CH, 1)
        self.output3 = conv_bn(2048, FPN_CH, 1)
        self.merge1 = conv_bn(FPN_CH, FPN_CH, 3)
        self.merge2 = conv_bn(FPN_CH, FPN_CH, 3)

    def forward(self, c3, c4, c5):
        o1 = F.relu(self.output1(c3))
        o2 = F.relu(self.output2(c4))
        o3 = F.relu(self.output3(c5))
        up3 = F.interpolate(o3, size=o2.shape[2:], mode='nearest-exact')
        o2 = F.relu(self.merge2(o2 + up3))
        up2 = F.interpolate(o2, size=o1.shape[2:], mode='nearest-exact')
        o1 = F.relu(self.merge1(o1 + up2))
        return o1, o2, o3


class SSH(nn.Module):
    """SSH context module (retinaface/network.py::SSH)."""

    def __init__(self):
        super().__init__()
        for name, cin, cout in SSH_CONVS:
            setattr(self, name, conv_bn(cin, cout, 3))

    def forward(self, x):
        c3 = self.conv3X3(x)
        c5_1 = F.relu(self.conv5X5_1(x))
        c5 = self.conv5X5_2(c5_1)
        c7 = self.conv7x7_3(F.relu(self.conv7X7_2(c5_1)))
        return F.relu(torch.cat([c3, c5, c7], dim=1))


class Head(nn.Module):
    def __init__(self, outputs: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(FPN_CH, 2 * outputs, 1)


class RetinaFaceNet(nn.Module):
    """Full detector: trunk -> FPN -> SSH -> per-level heads, on NHWC
    float32 input.

    Returns (loc (B, A, 4), conf (B, A, 2) softmaxed, landms (B, A, 10))
    with anchors ordered level-major, then row-major spatial, then the 2
    anchor sizes — matching PriorBox.
    """

    def __init__(self):
        super().__init__()
        self.body = Body()
        self.fpn = FPN()
        self.ssh1, self.ssh2, self.ssh3 = SSH(), SSH(), SSH()
        for name, outputs in HEADS:
            setattr(self, name, nn.ModuleList(Head(outputs)
                                              for _ in range(3)))

    def forward(self, x):
        feats = self.fpn(*self.body(x.permute(0, 3, 1, 2)))
        feats = [ssh(f) for ssh, f in zip((self.ssh1, self.ssh2, self.ssh3),
                                          feats)]
        out = []
        for name, outputs in HEADS:
            per_level = [head.conv1x1(f).permute(0, 2, 3, 1)
                         .reshape(f.shape[0], -1, outputs)
                         for head, f in zip(getattr(self, name), feats)]
            out.append(torch.cat(per_level, dim=1))
        loc, conf, ldm = out
        return loc, F.softmax(conf, dim=-1), ldm


# ------------------------------------------------------------- prior/decode
def prior_boxes(height: int, width: int) -> np.ndarray:
    """(A, 4) [cx, cy, sx, sy] normalized anchors
    (retinaface/prior_box.py), level-major / row-major / size-minor."""
    anchors = []
    for k, step in enumerate(STEPS):
        fh = int(math.ceil(height / step))
        fw = int(math.ceil(width / step))
        for i, j in product(range(fh), range(fw)):
            for min_size in MIN_SIZES[k]:
                s_kx = min_size / width
                s_ky = min_size / height
                cx = (j + 0.5) * step / width
                cy = (i + 0.5) * step / height
                anchors.append([cx, cy, s_kx, s_ky])
    return np.asarray(anchors, dtype=np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """(A, 4) [x0, y0, x1, y1] normalized (retinaface/box_utils.decode)."""
    v0, v1 = VARIANCES
    centers = priors[:, :2] + loc[:, :2] * v0 * priors[:, 2:]
    sizes = priors[:, 2:] * np.exp(loc[:, 2:] * v1)
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                           axis=1)
    return boxes


def decode_landmarks(ldm: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """(A, 5, 2) normalized (retinaface/box_utils.decode_landm)."""
    v0 = VARIANCES[0]
    pts = [priors[:, :2] + ldm[:, 2 * i:2 * i + 2] * v0 * priors[:, 2:]
           for i in range(5)]
    return np.stack(pts, axis=1)


def nms(boxes: np.ndarray, scores: np.ndarray, threshold: float
        ) -> List[int]:
    """Greedy IoU NMS (torchvision semantics: no +1 in areas)."""
    order = np.argsort(-scores)
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        xa = np.maximum(x0[i], x0[rest])
        ya = np.maximum(y0[i], y0[rest])
        xb = np.minimum(x1[i], x1[rest])
        yb = np.minimum(y1[i], y1[rest])
        inter = np.maximum(xb - xa, 0) * np.maximum(yb - ya, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-12)
        order = rest[iou <= threshold]
    return keep


def expected_state_dict_shapes() -> Dict[str, tuple]:
    """Torch-layout key -> shape map of the published checkpoint — the
    port's contract, used by tests to synthesize a state dict without
    torch/torchvision present."""
    shapes: Dict[str, tuple] = {'body.conv1.weight': (64, 3, 7, 7)}

    def bn(p, c):
        shapes[f'{p}.weight'] = (c,)
        shapes[f'{p}.bias'] = (c,)
        shapes[f'{p}.running_mean'] = (c,)
        shapes[f'{p}.running_var'] = (c,)

    bn('body.bn1', 64)
    in_c = 64
    for li, (planes, blocks) in enumerate([(64, 3), (128, 4),
                                           (256, 6), (512, 3)]):
        for b in range(blocks):
            base = f'body.layer{li + 1}.{b}'
            shapes[f'{base}.conv1.weight'] = (planes, in_c, 1, 1)
            bn(f'{base}.bn1', planes)
            shapes[f'{base}.conv2.weight'] = (planes, planes, 3, 3)
            bn(f'{base}.bn2', planes)
            shapes[f'{base}.conv3.weight'] = (planes * 4, planes, 1, 1)
            bn(f'{base}.bn3', planes * 4)
            if b == 0:
                shapes[f'{base}.downsample.0.weight'] = \
                    (planes * 4, in_c, 1, 1)
                bn(f'{base}.downsample.1', planes * 4)
            in_c = planes * 4

    for name, cin, k in (('output1', 512, 1), ('output2', 1024, 1),
                         ('output3', 2048, 1), ('merge1', FPN_CH, 3),
                         ('merge2', FPN_CH, 3)):
        shapes[f'fpn.{name}.0.weight'] = (FPN_CH, cin, k, k)
        bn(f'fpn.{name}.1', FPN_CH)

    for i in (1, 2, 3):
        for sub, cin, cout in (
                ('conv3X3', FPN_CH, FPN_CH // 2),
                ('conv5X5_1', FPN_CH, FPN_CH // 4),
                ('conv5X5_2', FPN_CH // 4, FPN_CH // 4),
                ('conv7X7_2', FPN_CH // 4, FPN_CH // 4),
                ('conv7x7_3', FPN_CH // 4, FPN_CH // 4)):
            shapes[f'ssh{i}.{sub}.0.weight'] = (cout, cin, 3, 3)
            bn(f'ssh{i}.{sub}.1', cout)

    for tname, cout in (('BboxHead', 8), ('ClassHead', 4),
                        ('LandmarkHead', 20)):
        for i in range(3):
            shapes[f'{tname}.{i}.conv1x1.weight'] = (cout, FPN_CH, 1, 1)
            shapes[f'{tname}.{i}.conv1x1.bias'] = (cout,)
    return shapes


# ------------------------------------------------------------- the detector
def _default_weights_path() -> Optional[str]:
    env = os.environ.get('FVT_RETINAFACE_WEIGHTS')
    if env:
        # an explicitly-set path must not silently degrade to the
        # center-box fallback (faces.default_detector catches
        # per-factory exceptions) — fail loudly here instead
        if not os.path.isfile(env):
            raise FileNotFoundError(
                f'FVT_RETINAFACE_WEIGHTS is set but no file exists at '
                f'{env!r}')
        return env
    hub = os.environ.get('TORCH_HOME',
                         os.path.expanduser('~/.cache/torch'))
    p = os.path.join(hub, 'hub', 'checkpoints',
                     'retinaface_resnet50_2020-07-20.pth')
    return p if os.path.isfile(p) else None


class RetinaFaceR50:
    """The detector behind the faces.py contract:
    ``detect(img_rgb) -> [{'bbox', 'score', 'landmarks'}, ...]`` sorted
    by score — the same output surface as the upstream's
    ``predict_jsons`` consumer (retinaface_align.py:183-237).

    ``model``: a :class:`RetinaFaceNet` (moved to ``device``), else one is
    loaded from ``weights_path`` or :func:`_default_weights_path`.
    """

    def __init__(self, confidence_threshold: float = 0.9,
                 nms_threshold: float = 0.4, max_size: int = 2048,
                 model: Optional[RetinaFaceNet] = None,
                 weights_path: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.threshold = confidence_threshold
        self.nms_threshold = nms_threshold
        self.max_size = max_size

        if model is None:
            path = weights_path or _default_weights_path()
            if path is None:
                raise FileNotFoundError(
                    'RetinaFace weights not found: set '
                    'FVT_RETINAFACE_WEIGHTS or place '
                    'retinaface_resnet50_2020-07-20.pth under '
                    '$TORCH_HOME/hub/checkpoints (the same file the '
                    'upstream downloads)')
            model = self.load_weights(path)
        self.model = model.to(self.device).eval()
        self._priors: Dict[Tuple[int, int], np.ndarray] = {}
        self._norm = (torch.from_numpy(NORM_MEAN).to(self.device),
                      torch.from_numpy(NORM_STD).to(self.device))

    @staticmethod
    def load_weights(path: str) -> RetinaFaceNet:
        """The published state dict (a legacy pickle stream or a zip; a
        ``{'state_dict': ...}`` wrapper is unwrapped) in a
        :class:`RetinaFaceNet` on the CPU, ``strict=True``."""
        sd = torch.load(path, map_location='cpu', weights_only=True)
        if isinstance(sd, dict) and 'state_dict' in sd:
            sd = sd['state_dict']
        model = RetinaFaceNet()
        model.load_state_dict(sd, strict=True)
        return model

    # -- preprocessing (ternaus predict_jsons contract) ----------------
    def _prepare(self, img_rgb: np.ndarray
                 ) -> Tuple[torch.Tensor, int, int]:
        """Returns (padded normalized (1, S, S, 3) image on the device, top
        pad, left pad); the inverse mapping in postprocess_detections needs
        only the pads — its resize_coeff = max(h, w) / max_size re-derives
        the scale."""
        h, w = img_rgb.shape[:2]
        scale = self.max_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        img = torch.from_numpy(np.ascontiguousarray(img_rgb)).to(self.device)
        if (nh, nw) != (h, w):
            # rectangular separable resize with the shared antialiased
            # triangle kernel, float32 products as fvt_tpu's host ones,
            # rounded to uint8 where fvt_tpu rounds
            wh = torch.from_numpy(resize_weights(h, nh).astype(np.float32))
            ww = torch.from_numpy(resize_weights(w, nw).astype(np.float32))
            x = img.to(torch.float32)
            with no_tf32():
                x = (wh.to(self.device) @ x.reshape(h, -1)).reshape(nh, w, -1)
                x = torch.einsum('hwc,pw->hpc', x, ww.to(self.device))
            img = torch.round(x).clamp_(0, 255).to(torch.uint8)
        mean, std = self._norm
        x = (img.to(torch.float32) / 255.0 - mean) / std
        # CENTER pad, like ternaus predict_jsons (pad_to_size computes
        # min_pad = (target - size) // 2 and unpad_from_size subtracts
        # it) — a corner pad would shift content by a non-multiple of
        # the stride-32 grid vs the upstream and perturb sub-stride
        # box/landmark alignment near borders
        pad_h = self.max_size - nh
        pad_w = self.max_size - nw
        top, left = pad_h // 2, pad_w // 2
        x = F.pad(x, (0, 0, left, pad_w - left, top, pad_h - top))
        return x[None], top, left

    def forward(self, x: torch.Tensor):
        """The network on a prepared batch, float32 with TF32 off."""
        with torch.inference_mode(), no_tf32():
            return self.model(x)

    def detect(self, img_rgb: np.ndarray) -> List[dict]:
        h, w = img_rgb.shape[:2]
        return self.detect_prepared(*self._prepare(img_rgb), h, w)

    def detect_prepared(self, x: torch.Tensor, top: int, left: int, h: int,
                        w: int) -> List[dict]:
        """``detect`` from ``_prepare``'s output for an (h, w) frame."""
        size = x.shape[1]
        loc_d, conf_d, ldm_d = self.forward(x.to(self.device))
        # D2H discipline: only the score column comes to the host, the
        # few kept rows of loc/ldm are gathered on the card
        scores = conf_d[0, :, 1].cpu().numpy()

        key = (size, size)
        if key not in self._priors:
            self._priors[key] = prior_boxes(size, size)
        priors = self._priors[key]

        keep = scores > self.threshold
        if not keep.any():
            return []
        sel = torch.from_numpy(np.nonzero(keep)[0]).to(self.device)
        locldm = torch.cat([loc_d[0][sel], ldm_d[0][sel]],
                           dim=1).cpu().numpy()
        boxes = decode_boxes(locldm[:, :4], priors[keep]) * size
        lands = decode_landmarks(locldm[:, 4:], priors[keep]) * size
        scores = scores[keep]

        kept = nms(boxes, scores, self.nms_threshold)
        out = postprocess_detections(boxes, lands, scores, kept,
                                     left, top, self.max_size, h, w)
        out.sort(key=lambda d: d['score'], reverse=True)
        return out


def postprocess_detections(boxes: np.ndarray, lands: np.ndarray,
                           scores: np.ndarray, kept: List[int],
                           left: int, top: int, max_size: int,
                           h: int, w: int) -> List[dict]:
    """ternaus ``predict_jsons`` output semantics, exactly:

      * boxes are truncated to int AT THE PADDED SCALE
        (``boxes[keep].int()``), un-padded, rescaled by
        ``resize_coeff = max(h, w) / max_size`` and truncated to int
        AGAIN (``.astype(int)``);
      * landmarks are un-padded as float, rescaled, truncated to int
        ONCE;
      * box corners are clipped with the upstream's asymmetric
        convention (``x_max`` to ``[x_min + 1, w - 1]``).

    The double truncation loses sub-pixel precision on purpose: the
    upstream's stores were built from these integer coordinates
    (retinaface_align.py:204-207 consumes them verbatim), and the
    5-point warp is exactly reproducible only from the same integers.
    """
    resize_coeff = max(h, w) / max_size
    unpad_b = np.array([left, top, left, top])
    unpad_l = np.array([left, top], np.float32)
    out = []
    for i in kept:
        b = boxes[i].astype(int)                      # trunc @ padded
        b = ((b - unpad_b) * resize_coeff).astype(int)  # trunc @ frame
        l5 = ((lands[i] - unpad_l) * resize_coeff).astype(int)
        x_min = int(np.clip(b[0], 0, w - 1))
        x_max = int(np.clip(b[2], x_min + 1, w - 1))
        y_min = int(np.clip(b[1], 0, h - 1))
        y_max = int(np.clip(b[3], y_min + 1, h - 1))
        out.append({'bbox': np.array([x_min, y_min, x_max, y_max], float),
                    'score': float(scores[i]),
                    'landmarks': l5.astype(np.float32)})
    return out
