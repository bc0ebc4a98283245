"""5-point face alignment: similarity transform + batched affine warp on
the card; the port of ``fvt_tpu/preprocess/facealign.py``.

The face.evoLVe warp the upstream uses (retinaface_align.py:239-252):
the cp2tform-style similarity transform from 5 facial landmarks to the
canonical reference points, solved on the host (a tiny lstsq per frame,
``fvt_tpu``'s numpy as it is), then a bilinear warp to a square crop.

The warp runs on ``device`` (None: the card): the uint8 frames are
uploaded once, the output grid is mapped through each frame's inverse
affine elementwise (a TF32 product would move ``floor`` across
integers), sampled with four gathers and the zero border, interpolated in
float32, then rounded and clipped to uint8 where the frames lie, and
copied to the host once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fvt_tpu_torch.train.steps import resolve_device

# canonical 5 points for a 96x112 crop (public face-alignment constants)
REFERENCE_FACIAL_POINTS = np.array([
    [30.29459953, 51.69630051],
    [65.53179932, 51.50139999],
    [48.02519989, 71.73660278],
    [33.54930115, 92.36550140],
    [62.72990036, 92.20410156],
], dtype=np.float32)
DEFAULT_CROP_SIZE = (96, 112)


def get_reference_facial_points(output_size: Optional[Tuple[int, int]] = None,
                                default_square: bool = False) -> np.ndarray:
    ref = REFERENCE_FACIAL_POINTS.copy()
    size = np.array(DEFAULT_CROP_SIZE, dtype=np.float32)
    if default_square:
        diff = size.max() - size
        ref += diff[None] / 2.0
        size += diff
    if output_size is not None:
        scale = np.array(output_size, dtype=np.float32) / size
        assert np.allclose(scale[0], scale[1]), 'non-uniform scale'
        ref *= scale[None]
    return ref


def _nonreflective_similarity(uv: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """cp2tform 'nonreflective similarity': 3x3 T with [u v 1] = [x y 1] T."""
    m = xy.shape[0]
    x = xy[:, 0:1]
    y = xy[:, 1:2]
    ones = np.ones((m, 1))
    zeros = np.zeros((m, 1))
    X = np.vstack([np.hstack([x, y, ones, zeros]),
                   np.hstack([y, -x, zeros, ones])])
    U = np.vstack([uv[:, 0:1], uv[:, 1:2]])
    r, _, rank, _ = np.linalg.lstsq(X, U, rcond=None)
    assert rank >= 3, 'points are degenerate'
    sc, ss, tx, ty = r.flatten()
    Tinv = np.array([[sc, -ss, 0.0], [ss, sc, 0.0], [tx, ty, 1.0]])
    return np.linalg.inv(Tinv)  # maps uv -> xy as [x y 1] = [u v 1] T


def similarity_transform(src_pts: np.ndarray, dst_pts: np.ndarray
                         ) -> np.ndarray:
    """Best of non-reflective / reflective similarity (cp2tform), returned
    as a 2x3 cv2-style matrix mapping src -> dst."""
    src = np.asarray(src_pts, dtype=np.float64).reshape(-1, 2)
    dst = np.asarray(dst_pts, dtype=np.float64).reshape(-1, 2)

    t1 = _nonreflective_similarity(src, dst)

    dst_r = dst.copy()
    dst_r[:, 0] = -dst_r[:, 0]
    t2r = _nonreflective_similarity(src, dst_r)
    reflect = np.array([[-1.0, 0, 0], [0, 1, 0], [0, 0, 1]])
    t2 = t2r @ reflect

    def norm_err(T):
        pts = np.hstack([src, np.ones((src.shape[0], 1))]) @ T
        return np.linalg.norm(pts[:, :2] - dst)

    T = t1 if norm_err(t1) <= norm_err(t2) else t2
    return T[:, :2].T  # 2x3


def invert_affine(tfm: np.ndarray) -> np.ndarray:
    """Invert a 2x3 affine matrix."""
    A = tfm[:, :2]
    b = tfm[:, 2]
    Ainv = np.linalg.inv(A)
    return np.hstack([Ainv, (-Ainv @ b)[:, None]])


def _bilinear_warp(img: torch.Tensor, inv_tfm: torch.Tensor, w_out: int,
                   h_out: int) -> torch.Tensor:
    """Sample img (T, H, W, C) (uint8 or float32) at each frame's affine map
    (T, 2, 3) of the output grid: (T, h_out * w_out, C) float32."""
    t, h, w = img.shape[:3]
    dev = img.device
    ys, xs = torch.meshgrid(torch.arange(h_out, dtype=torch.float32,
                                         device=dev),
                            torch.arange(w_out, dtype=torch.float32,
                                         device=dev), indexing='ij')
    gx, gy = xs.reshape(1, -1), ys.reshape(1, -1)
    a = inv_tfm[:, :, :, None]                       # (T, 2, 3, 1)
    # [x, y, 1] times each row of the map, elementwise: no fused
    # multiply-add, the same rounding on the card and on the host
    src_x = gx * a[:, 0, 0] + gy * a[:, 0, 1] + a[:, 0, 2]
    src_y = gx * a[:, 1, 0] + gy * a[:, 1, 1] + a[:, 1, 2]

    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    dx = (src_x - x0)[..., None]
    dy = (src_y - y0)[..., None]
    frame = torch.arange(t, device=dev)[:, None]

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi = xi.clamp(0, w - 1).long()
        yi = yi.clamp(0, h - 1).long()
        vals = img[frame, yi, xi].to(torch.float32)
        return torch.where(valid[..., None], vals, 0.0)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - dx) + v01 * dx
    bot = v10 * (1 - dx) + v11 * dx
    return top * (1 - dy) + bot * dy


def _warp(frames: np.ndarray, invs: np.ndarray, w_out: int, h_out: int,
          device: torch.device) -> np.ndarray:
    """(T, H, W, C) frames, (T, 2, 3) inverse maps -> (T, h_out, w_out, C)
    on the host; uint8 in, uint8 out (rounded half to even and clipped on
    the card, as ``np.rint``), else float32."""
    img = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    if img.dtype != torch.uint8:
        img = img.to(torch.float32)
    inv = torch.from_numpy(np.asarray(invs, np.float32)).to(device)
    out = _bilinear_warp(img, inv, w_out, h_out)
    if frames.dtype == np.uint8:
        out = torch.round(out).clamp_(0, 255).to(torch.uint8)
    return out.reshape(frames.shape[0], h_out, w_out, -1).cpu().numpy()


def warp_affine(img: np.ndarray, tfm: np.ndarray,
                out_size: Tuple[int, int], device=None) -> np.ndarray:
    """cv2.warpAffine-equivalent bilinear warp (border 0) on ``device``
    (None: the card)."""
    device = resolve_device(device)
    w_out, h_out = out_size
    inv = invert_affine(np.asarray(tfm, dtype=np.float32))
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return _warp(img[None], inv[None], w_out, h_out, device)[0]


def warp_and_crop_face(src_img: np.ndarray, facial_pts,
                       reference_pts: Optional[np.ndarray] = None,
                       crop_size: Tuple[int, int] = (112, 112),
                       device=None) -> np.ndarray:
    """5-point similarity warp to the canonical crop
    (face.evoLVe warp_and_crop_face semantics)."""
    if reference_pts is None:
        scale = crop_size[0] / 112.0
        reference_pts = get_reference_facial_points(
            default_square=True) * scale
    tfm = similarity_transform(np.asarray(facial_pts, dtype=np.float32),
                               reference_pts)
    return warp_affine(src_img, tfm, crop_size, device=device)


def batched_warp_faces(frames: np.ndarray, landmarks: np.ndarray,
                       out_size: int = 256, device=None) -> np.ndarray:
    """Warp a whole chunk of frames in one pass on ``device`` (None: the
    card).

    frames (T, H, W, 3); landmarks (T, 5, 2).  Transforms are solved on
    the host (T tiny lstsq's), sampling is one batched device program.
    """
    device = resolve_device(device)
    scale = out_size / 112.0
    reference = get_reference_facial_points(default_square=True) * scale
    invs = np.stack([
        invert_affine(similarity_transform(lm, reference))
        for lm in landmarks]).astype(np.float32)
    return _warp(np.asarray(frames), invs, out_size, out_size, device)
