"""Action-unit ellipsoid attention maps from 68-point landmarks: a copy of
``fvt_tpu/preprocess/au_ellipsoids.py`` (numpy on the host), held equal
to it by ``tests/test_torch_copies.py``.

The upstream's AU-heatmap construction (dlib/face_landmarks/
action_units.py:89-553): the 20-AU recipe table mapping iBUG-68
landmarks to filled ellipse ROIs, the per-expression AU selection
(EXP2AU), and ``build_all_action_units`` with its exact control flow —
background 1e-4 / fill 255, out-of-image ROIs flagged and dropped, 28x28
intermediate, 3x3 box blur, invalid landmarks -> a single +inf map.

Rasterization note: the upstream draws with cv2.ellipse (polygonal
approximation) and resizes with cv2 INTER_LINEAR; here ellipses are
filled analytically ((x-cx)^2/a^2 + (y-cy)^2/b^2 <= 1 at pixel centers)
and resampling uses the antialiased-bilinear kernel of
``data/host_resize.py``.  ROI geometry (centers, extents, is_roi flags,
EXP2AU selection) is the upstream's; boundary pixels of each ellipse may
differ by the rasterizer.  Research-viz module — not part of the
training path.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from fvt_tpu_torch import constants

AU = {0: 'Inner Brow Raiser',
      1: 'Outer Brow Raiser',
      2: 'Brow Lowerer',
      3: 'Upper Lid Raiser',
      4: 'Cheek Raiser',
      5: 'Lid Tightener',
      6: 'Nose Wrinkler',
      7: 'Upper Lip Raiser',
      8: 'Lip Corner Puller',
      9: 'Dimpler',
      10: 'Lip Corner Depressor',
      11: 'Chin Raiser',
      12: 'Lip Stretcher',
      13: 'Lip Tightener',
      14: 'Lip pressor',
      15: 'Lips Part',
      16: 'Jaw Drop',
      17: 'Eyes Closed',
      18: 'Mouth Stretcher',
      19: 'Lower Lip Depressor'}

EXP2AU = {
    constants.ANGER: [2, 3, 5, 7, 11, 13, 14, 15, 16],
    constants.DISGUST: [6, 3, 19, 11, 15, 16],
    constants.FEAR: [0, 1, 2, 3, 12, 15, 16, 18],
    constants.HAPPINESS: [4, 8, 15],
    constants.SADNESS: [0, 2, 4, 10, 11],
    constants.SURPRISE: [0, 1, 3, 16, 18],
}

GENERIC_AUS = sorted(AU)

HEATMAP_AUNITS_LNMKS = 'heatmap_aunits_lnmks'
HEATMAP_GENERIC_AUNITS_LNMKS = 'heatmap_generic_aunits_lnmks'

INTERMEDIATE = 28  # the reference rasterizes, then resizes ROI maps to 28^2


def _guard(v: int, floor: int) -> int:
    return floor if v == 0 else v


def au_ellipses(au: int, h: int, w: int, lms: Sequence[Tuple[int, int]]
                ) -> List[Tuple[int, int, int, int]]:
    """(cx, cy, major, minor) filled-ellipse list for one AU — the exact
    center/extent arithmetic of plot_action_units_ellipsoid
    (action_units.py:89-466), including its int truncations, zero-extent
    fallbacks and the duplicate-recipe AUs (10==8, 14==13, 18==16)."""
    p = [(int(x), int(y)) for x, y in lms]

    def eyes_pair(pad: int = 0):
        out = []
        for (a1, b1, a2, b2) in ((36, 38, 39, 41), (42, 44, 45, 47)):
            x = int((p[a1][0] + p[a2][0]) / 2)
            y = int((p[b1][1] + p[b2][1]) / 2)
            major = max(int((p[a2][0] - p[a1][0]) / 2), 0)
            minor = max(int((p[b2][1] + pad - p[b1][1] + pad) / 2), 0)
            out.append((x, y, major, minor))
        return out

    def mouth_box():
        x = int((p[48][0] + p[54][0]) / 2)
        y = int((p[51][1] + p[57][1]) / 2)
        major = _guard(max(int((p[54][0] - p[48][0]) / 2), 0), 5)
        minor = _guard(max(int((p[57][1] - p[51][1]) / 2), 0), 5)
        return [(x, y, major, minor)]

    if au == 0:
        major, minor = round(w / 8), round(h / 10)
        return [(p[20][0], p[20][1], major, minor),
                (p[23][0], p[23][1], major, minor)]
    if au == 1:
        major, minor = round(w / 8), round(h / 10)
        return [(p[18][0], p[18][1], major, minor),
                (p[25][0], p[25][1], major, minor)]
    if au == 2:
        x = int((p[19][0] + p[24][0]) / 2)
        y = int((p[19][1] + p[24][1]) / 2)
        major = _guard(max(int((p[24][0] - p[19][0]) / 2), 0), 10)
        minor = _guard(max(int((p[24][1] - p[19][1]) / 2), 0), 10)
        return [(x, y, major, minor)]
    if au == 3:
        return [(x, y, _guard(major, 5), _guard(minor, 5))
                for (x, y, major, minor) in eyes_pair(pad=0)]
    if au == 4:
        major, minor = round(w / 10), round(h / 10)
        return [(p[41][0], p[41][1] + round(h / 6), major, minor),
                (p[46][0], p[46][1] + round(h / 6), major, minor)]
    if au == 5:
        return [(x, y, _guard(major, 5), _guard(minor, 5))
                for (x, y, major, minor) in eyes_pair(pad=10)]
    if au == 6:
        y = p[29][1]
        return [(p[31][0], y, 20, 20), (p[35][0], y, 20, 20)]
    if au == 7:
        return [(p[48][0], p[50][1], 20, 20),
                (p[52][0], p[54][1], 20, 20)]
    if au in (8, 10):
        return [(p[48][0], p[48][1], 20, 20),
                (p[54][0], p[54][1], 20, 20)]
    if au == 9:
        lx = max(p[48][0] - 20, 0)
        rx = max(min(p[54][0] + 20, w), min(p[54][0] + 10, w))
        return [(lx, p[48][1], 20, 20), (rx, p[54][1], 20, 20)]
    if au == 11:
        x = int((p[59][0] + p[8][0]) / 2)
        y = int((p[59][1] + p[8][1]) / 2)
        major = _guard(max(int((p[8][0] - p[59][0]) / 2), 0), 5)
        minor = _guard(max(int((p[8][1] - p[59][1]) / 2), 0), 5)
        return [(x, y, major, minor)]
    if au == 12:
        return [(int((p[48][0] + p[6][0]) / 2),
                 int((p[48][1] + p[6][1]) / 2), 20, 20),
                (int((p[50][0] + p[10][0]) / 2),
                 int((p[50][1] + p[10][1]) / 2), 20, 20)]
    if au in (13, 14, 16, 18):
        return mouth_box()
    if au == 15:
        return [(p[51][0], p[51][1], 25, 10),
                (p[57][0], p[57][1], 25, 10)]
    if au == 17:
        return list(eyes_pair(pad=10))
    if au == 19:
        return [(p[59][0], p[59][1], 20, 20),
                (p[55][0], p[55][1], 20, 20)]
    raise ValueError(f'unknown action unit {au}')


def fill_ellipses(h: int, w: int,
                  ellipses: Sequence[Tuple[int, int, int, int]]
                  ) -> np.ndarray:
    """Analytic filled-ellipse union on an (h, w) grid: background 1e-4,
    fill 255 (the reference's cv2 colors).  All ellipses of one AU are
    rasterized in a single vectorized pass."""
    att = np.full((h, w), 1e-4, np.float32)
    if not ellipses:
        return att
    e = np.asarray(ellipses, np.float32)  # (n, 4): cx, cy, major, minor
    ys = np.arange(h, dtype=np.float32)[:, None, None]
    xs = np.arange(w, dtype=np.float32)[None, :, None]
    major = np.maximum(e[:, 2], 1e-6)
    minor = np.maximum(e[:, 3], 1e-6)
    d = (((xs - e[:, 0]) / major) ** 2 + ((ys - e[:, 1]) / minor) ** 2)
    att[np.any(d <= 1.0, axis=-1)] = 255.0
    return att


def _box_blur3(x: np.ndarray) -> np.ndarray:
    """3x3 mean filter with reflect-101 borders (cv2.blur defaults)."""
    p = np.pad(x, 1, mode='reflect')
    out = np.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            out += p[dy:dy + x.shape[0], dx:dx + x.shape[1]]
    return out / 9.0


def _resize(x: np.ndarray, h: int, w: int) -> np.ndarray:
    from fvt_tpu_torch.data.host_resize import resize_weights
    wh = resize_weights(x.shape[0], h)
    ww = resize_weights(x.shape[1], w)
    return wh @ x @ ww.T


def plot_action_units_ellipsoid(au: int, h: int, w: int,
                                lndmks: Sequence[Tuple[float, float]]
                                ) -> Tuple[np.ndarray, bool]:
    """One AU ROI map at 28x28 + validity flag (action_units.py:89-466):
    an ellipse drawn fully outside the image leaves the map empty and is
    flagged invalid (is_roi=False -> +inf map)."""
    assert len(lndmks) == 68, len(lndmks)
    att = fill_ellipses(h, w, au_ellipses(au, h, w, lndmks))
    is_roi = bool((att - 1e-4).sum() > 0)
    if not is_roi:
        return np.full((INTERMEDIATE, INTERMEDIATE), np.inf), False
    return _resize(att, INTERMEDIATE, INTERMEDIATE), True


def build_all_action_units(lndmks: Sequence[Tuple[float, float]],
                           h: int, w: int, cl: str,
                           aus_type: str = HEATMAP_GENERIC_AUNITS_LNMKS
                           ) -> np.ndarray:
    """(n_au, h, w) float32 attention maps for expression ``cl``
    (action_units.py:469-552): per-expression AU set or the generic
    20-AU set; NEUTRAL (expression mode) and invalid landmarks yield a
    single +inf map; failed ROIs are dropped from the stack."""
    assert len(lndmks) == 68, len(lndmks)
    assert cl in constants.EXPRESSIONS, cl
    invalid = np.asarray(lndmks[0][0]) == np.inf

    if aus_type == HEATMAP_AUNITS_LNMKS:
        if cl == constants.NEUTRAL or invalid:
            return np.full((1, h, w), np.inf, np.float32)
        aus = EXP2AU[cl]
    elif aus_type == HEATMAP_GENERIC_AUNITS_LNMKS:
        if invalid:
            return np.full((1, h, w), np.inf, np.float32)
        aus = GENERIC_AUS
    else:
        raise NotImplementedError(aus_type)

    maps = []
    for au in aus:
        att, is_roi = plot_action_units_ellipsoid(au, h, w, lndmks)
        if is_roi:
            maps.append(_resize(_box_blur3(att), h, w))

    if not maps:  # every ROI fell outside the image
        return np.full((1, h, w), np.inf, np.float32)
    return np.stack(maps).astype(np.float32)
