"""The port's 5-point face alignment (``fvt_tpu_torch/preprocess/
facealign.py``) against ``fvt_tpu``'s, on the CPU.

* The host math (the reference points, the cp2tform similarity, the
  affine inverse) is ``fvt_tpu``'s: exactly equal on seeded landmarks.
* ``batched_warp_faces`` on 2 and 4 frames at 256 and 112, float32 and
  uint8.  The source coordinates may round one float32 unit apart:
  ``fvt_tpu``'s vmapped product fuses the multiply-add in some frames and
  not in others (its own batched and one-frame warps differ so), and a
  bilinear sample moves by the image's gradient times that unit.  The
  frames are therefore smooth, as faces are (a few levels a pixel), the
  crops lie inside them (at the zero border the gradient is the edge's
  value a pixel), and float32 warps agree within ``WARP_ATOL``; uint8
  warps within one level,
  on at most ``UINT8_FLIPS`` of the values, the count asserted.
* ``warp_affine`` / ``warp_and_crop_face`` on one image the same way.
* every entry point refuses to run without a card when ``device`` is
  None.
"""
import jax
import numpy as np
import pytest
import torch

from fvt_tpu.preprocess import facealign as jax_fa
from fvt_tpu_torch.preprocess import facealign as fa

WARP_ATOL = 1e-3
UINT8_FLIPS = 1e-3
# a face in the middle of an (H, W) frame
H, W = 200, 240
LANDMARKS = np.array([[100, 80], [140, 80], [120, 100], [105, 120],
                      [135, 120]], np.float32)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread_x64_off():
    n = torch.get_num_threads()
    was_x64 = bool(jax.config.jax_enable_x64)
    torch.set_num_threads(1)
    jax.config.update('jax_enable_x64', False)
    yield
    jax.config.update('jax_enable_x64', was_x64)
    torch.set_num_threads(n)


def smooth_frames(t: int, h: int, w: int, seed: int) -> np.ndarray:
    """(t, h, w, 3) float32 in [0, 255]: a few low-frequency waves a
    channel, at most ~6 levels a pixel."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.zeros((t, h, w, 3))
    for i in range(t):
        for c in range(3):
            for _ in range(3):
                fy, fx = rng.uniform(0.01, 0.06, 2)
                out[i, :, :, c] += np.sin(fy * ys + fx * xs
                                          + rng.uniform(0, 6.3))
    out = 127.5 + 42 * out
    return np.clip(out, 0, 255).astype(np.float32)


def seeded_landmarks(t: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([LANDMARKS + rng.normal(size=(5, 2)).astype(np.float32)
                     * 4 for _ in range(t)])


def test_host_math_is_fvt_tpus():
    for size, square in ((None, False), (None, True), ((112, 112), True),
                         ((224, 224), True)):
        np.testing.assert_array_equal(
            fa.get_reference_facial_points(size, square),
            jax_fa.get_reference_facial_points(size, square))
    ref = fa.get_reference_facial_points(default_square=True) * 256 / 112
    for lm in seeded_landmarks(6, 1):
        for src, dst in ((lm, ref), (lm[:, ::-1], ref)):
            got = fa.similarity_transform(src, dst)
            np.testing.assert_array_equal(
                got, jax_fa.similarity_transform(src, dst))
            np.testing.assert_array_equal(fa.invert_affine(got),
                                          jax_fa.invert_affine(got))


def _check_warp(got: np.ndarray, want: np.ndarray, uint8: bool) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    if not uint8:
        err = float(np.abs(got - want).max())
        assert err <= WARP_ATOL, err
        return
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    flips = int(np.count_nonzero(diff))
    assert diff.max() <= 1, diff.max()
    assert flips <= UINT8_FLIPS * diff.size, (flips, diff.size)


@pytest.mark.parametrize('t,size', [(2, 256), (4, 112)])
@pytest.mark.parametrize('uint8', [False, True], ids=['float32', 'uint8'])
def test_batched_warp_matches_fvt_tpu(t, size, uint8):
    frames = smooth_frames(t, H, W, seed=t)
    if uint8:
        frames = np.rint(frames).astype(np.uint8)
    lms = seeded_landmarks(t, seed=size)
    got = fa.batched_warp_faces(frames, lms, out_size=size, device='cpu')
    want = jax_fa.batched_warp_faces(frames, lms, out_size=size)
    assert got.shape == (t, size, size, 3)
    _check_warp(got, want, uint8)


@pytest.mark.parametrize('uint8', [False, True], ids=['float32', 'uint8'])
def test_single_image_warps_match_fvt_tpu(uint8):
    img = smooth_frames(1, H, W, seed=9)[0]
    if uint8:
        img = np.rint(img).astype(np.uint8)
    lm = seeded_landmarks(1, seed=3)[0]
    _check_warp(fa.warp_and_crop_face(img, lm, device='cpu'),
                jax_fa.warp_and_crop_face(img, lm), uint8)
    tfm = np.array([[0.9, 0.2, -60.0], [-0.2, 0.9, -20.0]], np.float32)
    _check_warp(fa.warp_affine(img, tfm, (96, 112), device='cpu'),
                jax_fa.warp_affine(img, tfm, (96, 112)), uint8)


@pytest.mark.parametrize('entry', ['batched_warp_faces', 'warp_affine',
                                   'warp_and_crop_face'])
def test_entry_points_need_the_card_by_default(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    img = np.zeros((H, W, 3), np.uint8)
    calls = {
        'batched_warp_faces': lambda: fa.batched_warp_faces(
            img[None], LANDMARKS[None]),
        'warp_affine': lambda: fa.warp_affine(
            img, np.eye(2, 3, dtype=np.float32), (112, 112)),
        'warp_and_crop_face': lambda: fa.warp_and_crop_face(img, LANDMARKS)}
    with pytest.raises(RuntimeError, match='no CUDA device'):
        calls[entry]()
