"""The port's face crop/align chain (``fvt_tpu_torch/preprocess/faces.py``,
``compact.py``, ``recompact.py``) against ``fvt_tpu``'s, on the CPU.

* ``process_one_video`` against ``fvt_tpu``'s on the same seeded frames
  (``read_video_frames`` patched in both) and one injected detector that
  fails on chosen frames after the first: the crops within one level on
  at most ``UINT8_FLIPS`` of the values (the warp's rounding, see
  ``test_torch_facealign.py``), a failed frame a copy of the crop before
  it, the same ``frames.log`` and one jpg a frame.
* A leading run of failures, in the port only (``fvt_tpu``'s path there
  imports ``cv2``): the full frame resized by ``fan._resize_bilinear``,
  rounded.
* ``crop_faces_align`` over a two-block fold with a missing video: the
  same trials and block logs as ``fvt_tpu``'s.
* ``read_video_frames`` through stand-in ``ffprobe`` / ``ffmpeg`` scripts
  on ``PATH``; ``IOError`` with neither.
* ``compact_video_npy``, ``compact.main`` and ``recompact.main`` write
  ``fvt_tpu``'s files.
* ``default_detector``'s order and its loud failure on a wrong explicit
  weight path; the refusal to run without a card.
"""
import os
import stat
import sys

import jax
import numpy as np
import pytest
import torch

from fvt_tpu.preprocess import compact as jax_compact
from fvt_tpu.preprocess import faces as jax_faces
from fvt_tpu.preprocess import recompact as jax_recompact
from fvt_tpu_torch.preprocess import compact, faces, recompact
from fvt_tpu_torch.preprocess.fan import _resize_bilinear
from fvt_tpu_torch.preprocess.retinaface import RetinaFaceR50

UINT8_FLIPS = 1e-3
H, W = 200, 240
FACE = (60, 50, 120, 110)  # x, y, w, h of the drawn face


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread_x64_off():
    n = torch.get_num_threads()
    was_x64 = bool(jax.config.jax_enable_x64)
    torch.set_num_threads(1)
    jax.config.update('jax_enable_x64', False)
    yield
    jax.config.update('jax_enable_x64', was_x64)
    torch.set_num_threads(n)


def seeded_frames(n: int, seed: int = 0) -> list:
    """Smooth (H, W, 3) uint8 frames, a brighter face box in each."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    out = []
    for i in range(n):
        f = 90 + 40 * np.sin(0.03 * xs + 0.02 * ys + rng.uniform(0, 6))
        f = np.repeat(f[:, :, None], 3, axis=2) + [0, 10 * i % 40, 20]
        x, y, w, h = FACE
        f[y:y + h, x:x + w] += (60 + 20 * np.cos(
            0.05 * xs[y:y + h, x:x + w]))[:, :, None]
        out.append(np.clip(np.rint(f), 0, 255).astype(np.uint8))
    return out


class Detector:
    """The contract, failing on every frame outside ``hits``; the 5 points
    move with the frame index."""

    def __init__(self, hits):
        self.hits, self.calls = set(hits), 0

    def detect(self, img_rgb):
        i, self.calls = self.calls, self.calls + 1
        if i not in self.hits:
            return []
        x, y, w, h = FACE
        lms = jax_faces._box_landmarks(x + i, y - i, w, h)
        return [{'bbox': np.array([x, y, x + w, y + h], float),
                 'score': 0.99, 'landmarks': lms}]


def _close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert np.count_nonzero(diff) <= UINT8_FLIPS * diff.size


def _patch_reader(monkeypatch, frames):
    for module in (faces, jax_faces):
        monkeypatch.setattr(module, 'read_video_frames',
                            lambda path: iter(frames))


def test_process_one_video_matches_fvt_tpu(tmp_path, monkeypatch):
    frames = seeded_frames(8)
    _patch_reader(monkeypatch, frames)
    hits = {0, 1, 3, 4, 7}
    got = faces.process_one_video('clip.mp4', str(tmp_path / 'port'),
                                  Detector(hits), chunk=3, device='cpu')
    want = jax_faces.process_one_video('clip.mp4', str(tmp_path / 'jax'),
                                       Detector(hits), chunk=3)
    assert got.shape == (8, 256, 256, 3)
    _close(got, want)
    for i in (2, 5, 6):  # carried: the crop before, verbatim
        np.testing.assert_array_equal(got[i], got[i - 1])
    log = (tmp_path / 'port' / 'frames.log').read_text()
    assert log == (tmp_path / 'jax' / 'frames.log').read_text()
    assert log.splitlines()[:3] == ['0,1', '1,1', '2,0']
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(
        os.listdir(tmp_path / 'jax'))


def test_leading_failures_fall_back_to_the_resized_frame(tmp_path):
    frames = seeded_frames(6, seed=1)
    got = faces.process_frames(iter(frames), str(tmp_path), Detector({2, 3}),
                               store_jpgs=False, device='cpu')
    for i in (0, 1):
        want = np.clip(np.rint(_resize_bilinear(
            frames[i].astype(np.float32), 256, 256)), 0, 255)
        np.testing.assert_array_equal(got[i], want.astype(np.uint8))
    for i in (4, 5):
        np.testing.assert_array_equal(got[i], got[3])
    assert not np.array_equal(got[2], got[3])
    empty = faces.process_frames(iter([]), str(tmp_path), Detector({}),
                                 device='cpu')
    assert empty.shape == (0, 256, 256, 3)


def test_crop_faces_align_matches_fvt_tpu(tmp_path, monkeypatch):
    _patch_reader(monkeypatch, seeded_frames(4, seed=2))
    folds = tmp_path / 'folds' / 'split-0'
    folds.mkdir(parents=True)
    (folds / 'train.txt').write_text('a,0,hi\nb,1,\nghost,2,\n')
    vids = tmp_path / 'videos'
    vids.mkdir()
    for t in ('a', 'b'):
        (vids / f'{t}.mp4').write_bytes(b'')
    runs = {}
    for name, module, kw in (('port', faces, {'device': 'cpu'}),
                             ('jax', jax_faces, {})):
        out = str(tmp_path / name)
        done = []
        for block in range(2):
            done += module.crop_faces_align(
                str(tmp_path / 'folds'), str(vids), out, 'train', nblocks=2,
                process_block=block, detector=Detector(range(100)), **kw)
        logs = {f: open(os.path.join(out + '-logs', f)).read()
                .replace(out, '') for f in os.listdir(out + '-logs')}
        runs[name] = done, logs
    assert runs['port'] == runs['jax']
    assert runs['port'][0] == ['a', 'b']
    assert 'XXXX MISSING' in ''.join(runs['port'][1].values())


def _stand_in(bin_dir, name: str, body: str) -> None:
    path = bin_dir / name
    path.write_text(f'#!{sys.executable}\n{body}')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


FFPROBE = '''import json, sys
import numpy as np
frames = np.load(sys.argv[-1] + '.npy')
print(json.dumps({'streams': [{'width': frames.shape[2],
                               'height': frames.shape[1]}]}))
'''
FFMPEG = '''import sys
import numpy as np
frames = np.load(sys.argv[sys.argv.index('-i') + 1] + '.npy')
assert sys.argv[sys.argv.index('-pix_fmt') + 1] == 'rgb24'
sys.stdout.buffer.write(frames.tobytes())
'''


def test_read_video_frames_through_ffmpeg(tmp_path, monkeypatch):
    frames = np.stack(seeded_frames(3, seed=3))[:, :50, :70]
    video = tmp_path / 'clip.mp4'
    video.write_bytes(b'')
    np.save(str(video) + '.npy', frames)
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    monkeypatch.setenv('PATH', str(bin_dir))
    with pytest.raises(IOError, match='ffprobe is not on PATH'):
        list(faces.read_video_frames(str(video)))
    _stand_in(bin_dir, 'ffprobe', FFPROBE)
    with pytest.raises(IOError, match='ffmpeg is not on PATH'):
        list(faces.read_video_frames(str(video)))
    _stand_in(bin_dir, 'ffmpeg', FFMPEG)
    got = list(faces.read_video_frames(str(video)))
    assert len(got) == 3
    for g, f in zip(got, frames):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, f)
    with pytest.raises(IOError, match='cannot probe'):
        list(faces.read_video_frames(str(tmp_path / 'none.mp4')))


def test_compaction_writes_fvt_tpus_files(tmp_path):
    rng = np.random.default_rng(4)
    crops = rng.integers(0, 256, (5, 256, 256, 3), np.uint8)
    for name, module in (('port', faces), ('jax', jax_faces)):
        trial = tmp_path / name / 'features' / 'train' / 't0'
        trial.mkdir(parents=True)
        np.save(trial / 'vggish.npy', np.arange(7 * 2.0).reshape(7, 2))
        np.save(trial / 'bert.npy', np.zeros((5, 3)))
        module.compact_video_npy(str(trial), crops)
        with pytest.raises(AssertionError):
            np.save(trial / 'EXPR_continuous_label.npy', np.zeros(9))
            module.compact_video_npy(str(trial), crops, strict=True)
    for f in ('video.npy', 'vggish.npy', 'bert.npy'):
        a = np.load(tmp_path / 'port' / 'features' / 'train' / 't0' / f)
        b = np.load(tmp_path / 'jax' / 'features' / 'train' / 't0' / f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    # jpgs -> video.npy (compact), then video_48.npy (recompact)
    from PIL import Image
    faces_root = tmp_path / 'faces'
    for i in range(3):
        d = faces_root / 'train' / 't1' / f'frame-{i}'
        d.mkdir(parents=True)
        Image.fromarray(crops[i]).save(d / 'face-0.jpg')
    written = []
    for name, c_mod, r_mod in (('port', compact, recompact),
                               ('jax', jax_compact, jax_recompact)):
        feats = tmp_path / name / 'features'
        (feats / 'train' / 't1').mkdir()
        c_mod.main(['--faces_root', str(faces_root), '--features_root',
                    str(feats), '--split', 'train', '--ds', 'C-EXPR-DB'])
        r_mod.main(['--features_path', str(feats)])
        written.append([np.load(feats / 'train' / t / f) for t in ('t0', 't1')
                        for f in ('video.npy', 'video_48.npy')])
    for a, b in zip(*written):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert written[0][3].shape == (3, 48, 48, 3)


def test_default_detector_and_the_card(tmp_path, monkeypatch):
    monkeypatch.delenv('FVT_RETINAFACE_WEIGHTS', raising=False)
    monkeypatch.setenv('TORCH_HOME', str(tmp_path))
    det = faces.default_detector(device='cpu')
    assert isinstance(det, faces.CenterBoxDetector)
    img = seeded_frames(1)[0]
    want = jax_faces.CenterBoxDetector().detect(img)[0]
    got = det.detect(img)[0]
    for k in ('bbox', 'landmarks'):
        np.testing.assert_array_equal(got[k], want[k])
    monkeypatch.setenv('FVT_RETINAFACE_WEIGHTS', str(tmp_path / 'none.pth'))
    with pytest.raises(FileNotFoundError, match='no file exists'):
        faces.default_detector(device='cpu')
    path = tmp_path / 'r.pth'
    from fvt_tpu_torch.preprocess.retinaface import RetinaFaceNet
    torch.save(RetinaFaceNet().state_dict(), path)
    monkeypatch.setenv('FVT_RETINAFACE_WEIGHTS', str(path))
    assert isinstance(faces.default_detector(device='cpu'), RetinaFaceR50)

    (tmp_path / 'split-0').mkdir()
    (tmp_path / 'split-0' / 'train.txt').write_text('v,0,\n')
    (tmp_path / 'v.mp4').write_bytes(b'')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(faces, 'read_video_frames',
                        lambda path: iter(seeded_frames(1)))
    for call in (
            lambda: faces.process_frames(iter(seeded_frames(1)),
                                         str(tmp_path / 'x'), Detector({0})),
            lambda: faces.process_one_video('v.mp4', str(tmp_path / 'y'),
                                            Detector({0})),
            lambda: faces.native_retinaface_detector(),
            lambda: faces.crop_faces_align(
                str(tmp_path), str(tmp_path), str(tmp_path / 'z'), 'train',
                detector=Detector({0}))):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
