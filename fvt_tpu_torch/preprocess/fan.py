"""2D-FAN-4 68-point facial landmark network on the card; the port of
``fvt_tpu/preprocess/fan.py``.

The upstream extracts 68-pt landmarks with the ``face_alignment``
package (base/preprocessing.py:191-195: the 4-stack 2D FAN of Bulat &
Tzimiropoulos), feeding the landmark.npy feature and the AU pipeline.
:class:`FAN` is the whole network as an ``nn.Module`` under the
face_alignment names, so the published ``2DFAN4-cd938726ad.zip`` loads
as it is (weight shapes: :func:`expected_state_dict_shapes`):

  * base: 7x7/s2 conv (3->64) + BN/ReLU, ConvBlock(128), avgpool/2,
    ConvBlock(128), ConvBlock(256);
  * 4 stacked depth-4 hourglass modules (nearest-neighbour upsampling,
    avg-pool downsampling) with the FAN ConvBlock (3-way split
    out/2 + out/4 + out/4 channel concat, pre-activation BN/ReLU,
    BN/ReLU/1x1 conv shortcut on a channel change);
  * per-stack head: ConvBlock(256) -> 1x1 conv + BN/ReLU -> 1x1 conv to
    68 heatmaps (64x64); previous + bl(ll) + al(heatmaps) between stacks.

The face_alignment crop (detector bbox -> center lifted by 12% of the
box height, scale (w+h)/195, the 256x256 window of the 200*scale frame,
bilinear) and the heatmap decode (argmax, +-0.25 px toward the larger
neighbour, -0.5, back to image coordinates) are ``fvt_tpu``'s numpy, on
the host.  The forward runs on ``device`` (None: the card) in float32
with TF32 off.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fvt_tpu_torch.preprocess.melspec import no_tf32
from fvt_tpu_torch.train.steps import resolve_device

N_LANDMARKS = 68
N_STACKS = 4
HG_DEPTH = 4
FEATS = 256
REFERENCE_SCALE = 195.0
CROP_RESOLUTION = 256
HEATMAP_RESOLUTION = 64


# ------------------------------------------------------------------ blocks
def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class ConvBlock(nn.Module):
    """face_alignment.net.ConvBlock: pre-activation 3-way split block.

    out/2 + out/4 + out/4 channels concatenated; BN/ReLU/1x1 shortcut
    when the channel count changes.
    """

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = _conv3x3(cin, cout // 2)
        self.bn2 = nn.BatchNorm2d(cout // 2)
        self.conv2 = _conv3x3(cout // 2, cout // 4)
        self.bn3 = nn.BatchNorm2d(cout // 4)
        self.conv3 = _conv3x3(cout // 4, cout // 4)
        self.downsample = (nn.Sequential(
            nn.BatchNorm2d(cin), nn.ReLU(),
            nn.Conv2d(cin, cout, 1, bias=False)) if cin != cout else None)

    def forward(self, x):
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([out1, out2, out3], dim=1) + res


class HourGlass(nn.Module):
    """Depth-4 recursive hourglass (face_alignment.net.HourGlass)."""

    def __init__(self, depth: int = HG_DEPTH):
        super().__init__()
        self.depth = depth
        for d in range(depth, 0, -1):
            for b in ('b1', 'b2', 'b3'):
                self.add_module(f'{b}_{d}', ConvBlock(FEATS, FEATS))
        self.add_module('b2_plus_1', ConvBlock(FEATS, FEATS))

    def _level(self, inp, d):
        up1 = getattr(self, f'b1_{d}')(inp)
        low1 = getattr(self, f'b2_{d}')(F.avg_pool2d(inp, 2, stride=2))
        if d > 1:
            low2 = self._level(low1, d - 1)
        else:
            low2 = self.b2_plus_1(low1)
        low3 = getattr(self, f'b3_{d}')(low2)
        return up1 + F.interpolate(low3, scale_factor=2, mode='nearest')

    def forward(self, x):
        return self._level(x, self.depth)


class FAN(nn.Module):
    """4-stack FAN; input (N, 256, 256, 3) in [0, 1], NHWC; returns the
    last stack's (N, 64, 64, 68) heatmaps (face_alignment uses out[-1])."""

    def __init__(self, num_stacks: int = N_STACKS):
        super().__init__()
        self.num_stacks = num_stacks
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, FEATS)
        for i in range(num_stacks):
            self.add_module(f'm{i}', HourGlass())
            self.add_module(f'top_m_{i}', ConvBlock(FEATS, FEATS))
            self.add_module(f'conv_last{i}', nn.Conv2d(FEATS, FEATS, 1))
            self.add_module(f'bn_end{i}', nn.BatchNorm2d(FEATS))
            self.add_module(f'l{i}', nn.Conv2d(FEATS, N_LANDMARKS, 1))
            if i < num_stacks - 1:
                self.add_module(f'bl{i}', nn.Conv2d(FEATS, FEATS, 1))
                self.add_module(f'al{i}', nn.Conv2d(N_LANDMARKS, FEATS, 1))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x = F.avg_pool2d(self.conv2(x), 2, stride=2)
        x = self.conv4(self.conv3(x))

        previous = x
        tmp_out = None
        for i in range(self.num_stacks):
            ll = getattr(self, f'top_m_{i}')(getattr(self, f'm{i}')(previous))
            ll = F.relu(getattr(self, f'bn_end{i}')(
                getattr(self, f'conv_last{i}')(ll)))
            tmp_out = getattr(self, f'l{i}')(ll)
            if i < self.num_stacks - 1:
                previous = (previous + getattr(self, f'bl{i}')(ll)
                            + getattr(self, f'al{i}')(tmp_out))
        return tmp_out.permute(0, 2, 3, 1)


# --------------------------------------------------- crop / decode contract
def _transform_matrix(center, scale, resolution: float) -> np.ndarray:
    """face_alignment utils.transform's 3x3 output->input-frame map."""
    h = 200.0 * scale
    t = np.eye(3)
    t[0, 0] = resolution / h
    t[1, 1] = resolution / h
    t[0, 2] = resolution * (-center[0] / h + 0.5)
    t[1, 2] = resolution * (-center[1] / h + 0.5)
    return t


def transform_point(point, center, scale, resolution: float,
                    invert: bool = False) -> np.ndarray:
    """Map a (x, y) point between crop and original frames; truncates to
    int like face_alignment.utils.transform."""
    t = _transform_matrix(center, scale, resolution)
    if invert:
        t = np.linalg.inv(t)
    pt = np.array([point[0], point[1], 1.0])
    return (t @ pt)[:2].astype(np.int64).astype(np.float64)


def bbox_to_center_scale(bbox) -> Tuple[np.ndarray, float]:
    """face_alignment api.py: center with 12%-height lift, (w+h)/195."""
    x1, y1, x2, y2 = [float(v) for v in bbox[:4]]
    center = np.array([(x1 + x2) / 2.0, (y1 + y2) / 2.0])
    center[1] -= (y2 - y1) * 0.12
    scale = (x2 - x1 + y2 - y1) / REFERENCE_SCALE
    return center, scale


def crop_face(image: np.ndarray, center, scale,
              resolution: int = CROP_RESOLUTION) -> np.ndarray:
    """face_alignment utils.crop: subwindow + bilinear resize to 256."""
    ul = transform_point([1, 1], center, scale, resolution, invert=True)
    br = transform_point([resolution, resolution], center, scale,
                         resolution, invert=True)
    ul = ul.astype(int)
    br = br.astype(int)
    ht, wd = image.shape[0], image.shape[1]
    new_dim = np.array([br[1] - ul[1], br[0] - ul[0], 3], dtype=np.int32)
    new_img = np.zeros(new_dim, dtype=np.float32)
    new_x = np.array([max(1, -ul[0] + 1), min(br[0], wd) - ul[0]],
                     dtype=np.int32)
    new_y = np.array([max(1, -ul[1] + 1), min(br[1], ht) - ul[1]],
                     dtype=np.int32)
    old_x = np.array([max(1, ul[0] + 1), min(br[0], wd)], dtype=np.int32)
    old_y = np.array([max(1, ul[1] + 1), min(br[1], ht)], dtype=np.int32)
    new_img[new_y[0] - 1:new_y[1], new_x[0] - 1:new_x[1]] = \
        image[old_y[0] - 1:old_y[1], old_x[0] - 1:old_x[1]]
    return _resize_bilinear(new_img, resolution, resolution)


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int
                     ) -> np.ndarray:
    """cv2.INTER_LINEAR-convention bilinear resize (half-pixel centers)."""
    in_h, in_w = img.shape[:2]
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def decode_heatmaps(hm: np.ndarray, center, scale) -> np.ndarray:
    """face_alignment utils.get_preds_fromhm for one face.

    hm: (64, 64, 68) -> (68, 2) landmarks in ORIGINAL image coords.
    """
    h, w, k = hm.shape
    flat = hm.reshape(h * w, k)
    idx = flat.argmax(axis=0)
    px = (idx % w).astype(np.float64)
    py = (idx // w).astype(np.float64)
    preds = np.stack([px + 1, py + 1], axis=1)  # 1-based like torch code
    for j in range(k):
        ix, iy = int(px[j]), int(py[j])
        if 0 < ix < w - 1 and 0 < iy < h - 1:
            dx = hm[iy, ix + 1, j] - hm[iy, ix - 1, j]
            dy = hm[iy + 1, ix, j] - hm[iy - 1, ix, j]
            preds[j, 0] += np.sign(dx) * 0.25
            preds[j, 1] += np.sign(dy) * 0.25
    preds -= 0.5
    out = np.zeros((k, 2), dtype=np.float32)
    for j in range(k):
        out[j] = transform_point(preds[j], center, scale, h, invert=True)
    return out


def _convblock_shapes(shapes, p, cin, f):
    shapes[f'{p}.bn1.weight'] = (cin,)
    shapes[f'{p}.conv1.weight'] = (f // 2, cin, 3, 3)
    shapes[f'{p}.bn2.weight'] = (f // 2,)
    shapes[f'{p}.conv2.weight'] = (f // 4, f // 2, 3, 3)
    shapes[f'{p}.bn3.weight'] = (f // 4,)
    shapes[f'{p}.conv3.weight'] = (f // 4, f // 4, 3, 3)
    if cin != f:
        shapes[f'{p}.downsample.0.weight'] = (cin,)
        shapes[f'{p}.downsample.2.weight'] = (f, cin, 1, 1)


def expected_state_dict_shapes() -> Dict[str, tuple]:
    """Torch key -> weight shape for the 2DFAN4 checkpoint (conv weights
    listed; each BatchNorm's .weight listed, its .bias/.running_mean/
    .running_var of the same length)."""
    shapes: Dict[str, tuple] = {
        'conv1.weight': (64, 3, 7, 7), 'conv1.bias': (64,),
        'bn1.weight': (64,),
    }
    _convblock_shapes(shapes, 'conv2', 64, 128)
    _convblock_shapes(shapes, 'conv3', 128, 128)
    _convblock_shapes(shapes, 'conv4', 128, 256)
    for i in range(N_STACKS):
        for d in range(1, HG_DEPTH + 1):
            for b in ('b1', 'b2', 'b3'):
                _convblock_shapes(shapes, f'm{i}.{b}_{d}', FEATS, FEATS)
            if d == 1:
                _convblock_shapes(shapes, f'm{i}.b2_plus_1', FEATS,
                                  FEATS)
        _convblock_shapes(shapes, f'top_m_{i}', FEATS, FEATS)
        shapes[f'conv_last{i}.weight'] = (FEATS, FEATS, 1, 1)
        shapes[f'conv_last{i}.bias'] = (FEATS,)
        shapes[f'bn_end{i}.weight'] = (FEATS,)
        shapes[f'l{i}.weight'] = (N_LANDMARKS, FEATS, 1, 1)
        shapes[f'l{i}.bias'] = (N_LANDMARKS,)
        if i < N_STACKS - 1:
            shapes[f'bl{i}.weight'] = (FEATS, FEATS, 1, 1)
            shapes[f'bl{i}.bias'] = (FEATS,)
            shapes[f'al{i}.weight'] = (FEATS, N_LANDMARKS, 1, 1)
            shapes[f'al{i}.bias'] = (FEATS,)
    return shapes


def _default_weights_path() -> Optional[str]:
    p = os.environ.get('FVT_FAN_WEIGHTS')
    if p:
        # an explicitly-set path must fail loudly, not silently degrade
        # to "weights absent" (mirrors retinaface._default_weights_path)
        if not os.path.isfile(p):
            raise FileNotFoundError(
                f'FVT_FAN_WEIGHTS is set but no file exists at {p!r}')
        return p
    hub = os.path.join(
        os.environ.get('TORCH_HOME',
                       os.path.expanduser('~/.cache/torch')),
        'hub', 'checkpoints', '2DFAN4-cd938726ad.zip')
    return hub if os.path.isfile(hub) else None


# ---------------------------------------------------------------- runtime
class FANLandmarks:
    """68-pt landmark extractor: detector bbox in, (68, 2) out; the
    forward on ``device`` (None: the card), the crop and the decode on the
    host.

    Usage::

        fan = FANLandmarks()                      # needs weights
        lms = fan.predict(img_rgb_u8, bbox)       # original coords
    """

    def __init__(self, weights_path: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        path = weights_path or _default_weights_path()
        if path is None:
            raise NotImplementedError(
                '2DFAN4 weights not found: set FVT_FAN_WEIGHTS or place '
                '2DFAN4-cd938726ad.zip in the torch-hub cache (the '
                'architecture itself is native — see preprocess/fan.py)')
        self.model = FAN()
        self.model.load_state_dict(self.load_weights(path), strict=True)
        self.model.to(self.device).eval()

    @staticmethod
    def load_weights(path: str) -> Dict[str, torch.Tensor]:
        """The state dict of a TorchScript archive (the published
        ``2DFAN4-cd938726ad.zip``, which ``torch.load(weights_only=True)``
        refuses), of a plain state-dict file, or of an ``.npz``."""
        if path.endswith('.npz'):
            with np.load(path) as z:
                return {k: torch.from_numpy(z[k]) for k in z.files}
        try:
            sd = torch.jit.load(path, map_location='cpu').state_dict()
        except RuntimeError:  # not a TorchScript archive
            sd = torch.load(path, map_location='cpu', weights_only=True)
        return dict(sd)

    def heatmaps(self, crops: np.ndarray) -> np.ndarray:
        """(N, 256, 256, 3) float crops in [0, 1] -> (N, 64, 64, 68)
        heatmaps on the host."""
        x = torch.from_numpy(np.asarray(crops, np.float32)).to(self.device)
        with torch.inference_mode(), no_tf32():
            return self.model(x).cpu().numpy()

    def predict(self, img_rgb: np.ndarray, bbox) -> np.ndarray:
        center, scale = bbox_to_center_scale(bbox)
        crop = crop_face(img_rgb.astype(np.float32), center, scale)
        # face_alignment's crop buffer is uint8 and cv2.resize emits
        # uint8 before the /255 normalize: quantize like it does (cv2's
        # fixed-point INTER_LINEAR differs from this float evaluation by
        # <=1 lsb on uint8-range inputs)
        crop = np.clip(np.rint(crop), 0.0, 255.0)
        hm = self.heatmaps(crop[None] / 255.0)[0]
        return decode_heatmaps(hm, center, scale)


def make_full_frame_landmarker(weights_path: Optional[str] = None,
                               device=None):
    """Landmarker over ALREADY-CROPPED faces (the driver's landmark.npy
    chain step): the whole image is the face, so the FAN crop derives
    from the full-frame box.  The upstream's FacenetController instead
    runs face_alignment.get_landmarks on its MTCNN crop, whose internal
    SFD box jitters the FAN window — outputs agree to a few px, not
    bit-exactly (video.py:249-292)."""
    fan = FANLandmarks(weights_path, device=device)

    def landmarker(img_rgb: np.ndarray) -> np.ndarray:
        h, w = img_rgb.shape[:2]
        return fan.predict(img_rgb, (0, 0, w, h))

    return landmarker


def extract_landmarks_68_native(img_rgb: np.ndarray,
                                detector=None,
                                fan: Optional[FANLandmarks] = None,
                                device=None) -> np.ndarray:
    """Native 68-pt extraction: detector -> FAN (mirrors
    faces.extract_landmarks_68's contract).

    Fidelity note: the upstream's FaceAlignment detects the face box
    with its built-in SFD detector before cropping; this path uses
    ``default_detector()`` (RetinaFace when weights are present).
    FAN's crop is box-derived (center/scale), so a slightly different
    box jitters the crop window — landmark outputs agree to a few px,
    not bit-exactly, with the package path."""
    if fan is None:
        fan = FANLandmarks(device=device)
    if detector is None:
        from fvt_tpu_torch.preprocess.faces import default_detector
        detector = default_detector(device=device)
    dets = detector.detect(img_rgb)
    assert dets, 'no face found'
    return fan.predict(img_rgb, dets[0]['bbox'])
