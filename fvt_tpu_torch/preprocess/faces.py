"""Face crop/align video driver + compaction to video.npy; the port of
``fvt_tpu/preprocess/faces.py``.

The upstream's dlib/c_expr_db.py:284-463 and
dlib/compact_face_images.py:93-298:

  * per video: frame loop -> detect faces -> 5-point warp to 256x256 ->
    per-frame jpg store + frame log; on detection failure the previous
    frame's crop is reused (c_expr_db.py:384-392);
  * the warp runs on the card (facealign.batched_warp_faces) over chunks
    of frames instead of per-frame cv2 calls;
  * compaction gathers the top face per frame into a (n, 256, 256, 3)
    uint8 ``video.npy`` and asserts the other modality arrays agree on the
    frame count (truncating them when longer, the upstream's fixup
    compact_face_images.py:245-276).

Videos are decoded through an ``ffmpeg`` rawvideo ``rgb24`` pipe, the
geometry from ``ffprobe``; without them :func:`read_video_frames` raises
``IOError``.  :func:`process_frames` takes frames from any iterable, and
:func:`process_one_video` feeds it a file's.  The detector is pluggable:
the port's RetinaFace-R50 when its weights are present, the ternaus
package's when it is installed, else a centred box.  ``fvt_tpu``'s Haar
cascade is not ported: it needs ``cv2``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
from os.path import join
from typing import Iterable, List, Optional, Tuple

import numpy as np

from fvt_tpu_torch import constants
from fvt_tpu_torch.preprocess.facealign import batched_warp_faces
from fvt_tpu_torch.preprocess.fan import _resize_bilinear
from fvt_tpu_torch.train.steps import resolve_device
from fvt_tpu_torch.utils.logger import log

OUT_SIZE = 256


# ------------------------------------------------------------- detectors
def _box_landmarks(x, y, w, h) -> np.ndarray:
    """Canonical in-box 5-landmark geometry (fractions of the box)."""
    return np.array([
        [x + 0.30 * w, y + 0.40 * h],   # left eye
        [x + 0.70 * w, y + 0.40 * h],   # right eye
        [x + 0.50 * w, y + 0.62 * h],   # nose
        [x + 0.35 * w, y + 0.80 * h],   # left mouth
        [x + 0.65 * w, y + 0.80 * h],   # right mouth
    ], dtype=np.float32)


class CenterBoxDetector:
    """Zero-dependency stub: one centered box + geometric landmarks.

    Keeps the pipeline runnable with no detector weights at all;
    fidelity is the full-frame fallback the upstream itself uses when
    detection fails."""

    def detect(self, img_rgb: np.ndarray) -> List[dict]:
        h, w = img_rgb.shape[:2]
        s = min(h, w) * 0.8
        x = (w - s) / 2.0
        y = (h - s) / 2.0
        return [{'bbox': np.array([x, y, x + s, y + s], float),
                 'score': 1.0, 'landmarks': _box_landmarks(x, y, s, s)}]


class RetinaFaceDetector:
    """The upstream's detector (retinaface_align.py:64-185); gated on the
    ternaus retinaface package + weights being installed."""

    def __init__(self, confidence_threshold: float = 0.9, device=None):
        from retinaface.pre_trained_models import get_model  # gated import
        self.threshold = confidence_threshold
        self.model = get_model('resnet50_2020-07-20', max_size=2048,
                               device=str(resolve_device(device)))
        self.model.eval()

    def detect(self, img_rgb: np.ndarray) -> List[dict]:
        preds = self.model.predict_jsons(
            img_rgb, confidence_threshold=self.threshold,
            nms_threshold=0.4)
        out = []
        for p in preds:
            if p['score'] == -1:
                continue
            out.append({'bbox': np.asarray(p['bbox'], float),
                        'score': float(p['score']),
                        'landmarks': np.asarray(p['landmarks'],
                                                np.float32)})
        out.sort(key=lambda d: d['score'], reverse=True)
        return out


def extract_landmarks_68(img_rgb: np.ndarray, device=None) -> np.ndarray:
    """68-point landmark extraction (the upstream's
    base/preprocessing.py:191-195 FaceAlignment(LandmarksType._2D)).

    Preferred path: the port's 2D-FAN-4 (preprocess/fan.py), which needs
    only the published 2DFAN4 weight file (FVT_FAN_WEIGHTS or torch-hub
    cache).  Falls back to the face_alignment package if installed; a
    clear gate error otherwise.
    """
    try:
        from fvt_tpu_torch.preprocess.fan import extract_landmarks_68_native
        return extract_landmarks_68_native(img_rgb, device=device)
    except NotImplementedError:
        pass  # no FAN weights on disk — try the external package
    try:
        import face_alignment
    except ImportError as e:
        raise NotImplementedError(
            '68-pt landmarks need either the 2DFAN4 weight file '
            '(FVT_FAN_WEIGHTS, native path: preprocess/fan.py) or the '
            'face_alignment package; the 5-pt detector path covers '
            'crop/align') from e
    fa = face_alignment.FaceAlignment(
        face_alignment.LandmarksType.TWO_D,
        device=str(resolve_device(device)))
    preds = fa.get_landmarks(img_rgb)
    assert preds, 'no face found'
    return np.asarray(preds[0], dtype=np.float32)


def native_retinaface_detector(confidence_threshold: float = 0.9,
                               device=None):
    """The port's RetinaFace-R50 (preprocess/retinaface.py) — the
    upstream's detector without the ternaus package; needs only the
    published weight file (FVT_RETINAFACE_WEIGHTS or torch-hub cache)."""
    from fvt_tpu_torch.preprocess.retinaface import RetinaFaceR50
    return RetinaFaceR50(confidence_threshold=confidence_threshold,
                         device=device)


def default_detector(device=None):
    for factory in (native_retinaface_detector, RetinaFaceDetector,
                    CenterBoxDetector):
        try:
            return (factory() if factory is CenterBoxDetector
                    else factory(device=device))
        except FileNotFoundError:
            if os.environ.get('FVT_RETINAFACE_WEIGHTS'):
                # the user EXPLICITLY pointed at weights but the path is
                # wrong — degrading to the center box here would
                # silently produce store-incompatible crops
                raise
            log(f'detector {factory.__name__} unavailable (no weight '
                f'file in image); trying next')
            continue
        except Exception as e:
            log(f'detector {factory.__name__} unavailable '
                f'({type(e).__name__}: {e}); trying next')
            continue
    raise RuntimeError('no face detector available')


# ----------------------------------------------------------- video driver
def _tool(name: str) -> str:
    path = shutil.which(name)
    if path is None:
        raise IOError(f'{name} is not on PATH: it decodes and probes the '
                      f'videos')
    return path


def ffprobe_stream(path: str, *entries: str) -> dict:
    """``ffprobe``'s JSON of the first video stream of ``path``,
    ``entries`` its arguments before ``-of json``; IOError where ffprobe
    is absent or finds no video stream."""
    proc = subprocess.run(
        [_tool('ffprobe'), '-v', 'error', '-select_streams', 'v:0',
         *entries, '-of', 'json', path], capture_output=True, text=True)
    try:
        return json.loads(proc.stdout)['streams'][0]
    except (ValueError, KeyError, IndexError) as e:
        raise IOError(f'cannot probe video {path}: '
                      f'{proc.stderr.strip()}') from e


def read_video_frames(path: str):
    """Yield RGB uint8 frames (c_expr_db.py:344-398): ffmpeg decodes the
    file to raw ``rgb24`` on a pipe, every frame as it is stored (no
    frame-rate conversion), at ffprobe's geometry."""
    stream = ffprobe_stream(path, '-show_entries', 'stream=width,height')
    w, h = int(stream['width']), int(stream['height'])
    size = w * h * 3
    proc = subprocess.Popen(
        [_tool('ffmpeg'), '-v', 'error', '-nostdin', '-i', path,
         '-vsync', 'passthrough', '-f', 'rawvideo', '-pix_fmt', 'rgb24',
         '-'], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    try:
        while True:
            buf = proc.stdout.read(size)
            if len(buf) < size:
                break
            # a writable frame, as cv2 gives (the warp uploads it)
            yield np.frombuffer(buf, np.uint8).reshape(h, w, 3).copy()
    finally:
        proc.stdout.close()
        proc.kill()
        proc.wait()


def process_frames(frames: Iterable[np.ndarray], out_dir: str,
                   detector, chunk: int = 64, store_jpgs: bool = True,
                   device=None) -> np.ndarray:
    """Detect+align every frame of ``frames`` (RGB uint8); returns (n, 256,
    256, 3) uint8 top faces.  The warp runs on ``device`` (None: the card).

    Failure semantics match the upstream exactly: a frame with no
    detection stores a COPY of the previous frame's cropped face
    (c_expr_db.py:384-392 does ``faces = previous_faces`` — the stale
    LANDMARKS are not re-applied to the new frame); a leading run of
    failures falls back to the full frame, resized as cv2.INTER_LINEAR
    does (``fan._resize_bilinear``, rounded; within one level of cv2's
    fixed point).

    Raw frames are held only for the current warp chunk (and
    leading-failure fallbacks), not the whole video — a long 1080p clip
    would otherwise buffer tens of GB before the first warp.
    """
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)

    frame_log = []
    warped: dict = {}            # frame idx -> 256^2 crop
    fallback: dict = {}          # leading-failure idx -> raw frame
    pending: List[np.ndarray] = []
    pend_lms: List[np.ndarray] = []
    pend_idx: List[int] = []

    def flush():
        if not pending:
            return
        crops = batched_warp_faces(np.stack(pending), np.stack(pend_lms),
                                   out_size=OUT_SIZE, device=device)
        for j, idx in enumerate(pend_idx):
            warped[idx] = crops[j]
        pending.clear()
        pend_lms.clear()
        pend_idx.clear()

    n = 0
    seen_detection = False
    for i, frame in enumerate(frames):
        n = i + 1
        dets = detector.detect(frame)
        frame_log.append((i, len(dets)))
        if dets:
            seen_detection = True
            pending.append(frame)
            pend_lms.append(np.asarray(dets[0]['landmarks']))
            pend_idx.append(i)
            if len(pending) >= chunk:
                flush()
        elif not seen_detection:
            fallback[i] = frame
        # else: carry — filled from out[i-1] at assembly
    flush()

    if n == 0:
        return np.zeros((0, OUT_SIZE, OUT_SIZE, 3), np.uint8)

    out = np.zeros((n, OUT_SIZE, OUT_SIZE, 3), np.uint8)
    for i, frame in fallback.items():
        out[i] = np.clip(np.rint(_resize_bilinear(
            frame.astype(np.float32), OUT_SIZE, OUT_SIZE)), 0, 255)
    for i in range(n):
        if i in warped:
            out[i] = warped[i]
        elif i not in fallback:
            out[i] = out[i - 1]  # previous frame's faces, verbatim

    if store_jpgs:
        from PIL import Image
        for i in range(n):
            fd = join(out_dir, f'frame-{i}')
            os.makedirs(fd, exist_ok=True)
            Image.fromarray(out[i]).save(join(fd, 'face-0.jpg'))
        with open(join(out_dir, 'frames.log'), 'w') as f:
            for i, k in frame_log:
                f.write(f'{i},{k}\n')

    return out


def process_one_video(video_path: str, out_dir: str, detector=None,
                      chunk: int = 64, store_jpgs: bool = True,
                      device=None) -> np.ndarray:
    """:func:`process_frames` over the frames of ``video_path``."""
    detector = detector or default_detector(device=device)
    return process_frames(read_video_frames(video_path), out_dir, detector,
                          chunk=chunk, store_jpgs=store_jpgs, device=device)


# ------------------------------------------------------------- compaction
def compact_video_npy(trial_dir: str, faces: np.ndarray,
                      features: Tuple[str, ...] = (constants.VGGISH,
                                                   constants.BERT,
                                                   constants.EXPR),
                      strict: bool = False):
    """Write video.npy and reconcile other modality lengths
    (compact_face_images.py:204-292).

    Writes go to a temp name and are atomically renamed: np.save opens
    'wb' and truncates in place, and a reader (the loader's native mmap
    gather, or numpy's own mmap fallback) that validated its indices
    against the OLD size would SIGBUS mid-copy when the file shrinks
    under it.  rename swaps the inode instead, so in-flight readers keep
    their (complete) old mapping."""
    n = faces.shape[0]
    _atomic_save(join(trial_dir, 'video.npy'), faces)
    for feature in features:
        path = join(trial_dir, f'{feature}.npy')
        if not os.path.isfile(path):
            continue
        arr = np.load(path)
        if arr.shape[0] > n:
            # MELD compaction must FAIL on a length mismatch like the
            # upstream (compact_face_images.py:248 hard-asserts
            # sz == n for MELD): the arranger trusts dataset_info's
            # recorded length for MELD (it only re-reads video.npy for
            # C-EXPR-DB*), so a silent truncation here would surface
            # epochs later as an IndexError in the loader.
            assert not strict, \
                f"{feature}: {arr.shape[0]} != {n} frames ({trial_dir})"
            log(f"truncating {feature} {arr.shape[0]} -> {n} frames "
                f"({trial_dir})")
            _atomic_save(path, arr[:n])
        else:
            assert arr.shape[0] == n, \
                f"{feature}: {arr.shape[0]} != {n} frames ({trial_dir})"


def _atomic_save(path: str, arr: np.ndarray):
    tmp = f'{path}.{os.getpid()}.tmp.npy'
    try:
        np.save(tmp, arr)
        os.replace(tmp, path)
    finally:
        if os.path.isfile(tmp):
            os.remove(tmp)


# ---------------------------------------------------- sharded fold CLI
def crop_faces_align(folds_dir: str, videos_root: str, out_root: str,
                     split: str, nblocks: int = 1, process_block: int = 0,
                     detector=None, video_ext: str = '.mp4',
                     logs_root: Optional[str] = None,
                     device=None) -> List[str]:
    """Crop/align every video of one fold-split block
    (c_expr_db.py:407-463 + its __main__ :828-864).

    The split txt (``<folds_dir>/split-0/<split>.txt``, lines
    ``<video_id>,<label>,<transcript>``) is divided into ``nblocks``
    contiguous blocks (sharding.better_chunks_into_n, the upstream's
    block math) and only ``process_block`` is processed — the
    embarrassingly-parallel job-array pattern the upstream uses for its
    preprocessing fleet.  Per-block log file + per-video frame logs land
    under ``logs_root`` (default ``<out_root>-logs``) with the upstream's
    ``log-nblocks-N-process-block-K.txt`` naming.

    Divergence, documented: the upstream stores top-10 faces per frame
    for the valid split (c_expr_db.py:459-460) purely for later human
    review; the downstream compaction only ever reads the top face
    (compact_face_images.py:93-132), so this driver stores top-1
    (``face-0.jpg``) for every split.

    A video whose decode yields zero frames is logged as corrupted and
    skipped.  Already-processed videos (``frames.log`` present) are
    skipped for idempotent re-runs.  Returns the processed trial ids.
    """
    from fvt_tpu_torch.preprocess.sharding import better_chunks_into_n

    assert nblocks > 0, nblocks
    assert 0 <= process_block < nblocks, (process_block, nblocks)
    path_fold = join(folds_dir, 'split-0', f'{split}.txt')
    assert os.path.isfile(path_fold), path_fold
    with open(path_fold) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    assert nblocks <= len(lines), (nblocks, len(lines))
    block = better_chunks_into_n(lines, nblocks)[process_block]

    logs_root = logs_root or (out_root.rstrip(os.sep) + '-logs')
    os.makedirs(logs_root, exist_ok=True)
    log_path = join(logs_root, f'log-nblocks-{nblocks}-'
                               f'process-block-{process_block}.txt')
    detector = detector or default_detector(device=device)

    done: List[str] = []
    with open(log_path, 'a') as lf:
        for ln in block:
            trial = ln.split(',')[0]
            p_video = join(videos_root, trial + video_ext)
            out_dir = join(out_root, trial)
            if os.path.isfile(join(out_dir, 'frames.log')):
                lf.write(f'video: {p_video}. SKIP (already cropped)\n')
                done.append(trial)
                continue
            if not os.path.isfile(p_video):
                lf.write(f'video: {p_video}. XXXX MISSING\n')
                continue
            faces = process_one_video(p_video, out_dir, detector=detector,
                                      store_jpgs=True, device=device)
            if faces.shape[0] == 0:
                lf.write(f'video: {p_video}. N-frames: 0  XXXX CORRUPTED\n')
                continue
            lf.write(f'video: {p_video}. N-frames: {faces.shape[0]}\n')
            done.append(trial)
    log(f'Done cropping faces: split={split}, nblocks={nblocks}, '
        f'block={process_block} ({len(done)}/{len(block)} videos)')
    return done


def main(argv=None, device=None):
    import argparse
    p = argparse.ArgumentParser(
        description='fvt_tpu_torch face crop/align (sharded fold driver)')
    p.add_argument('--folds_dir', required=True)
    p.add_argument('--videos_root', required=True)
    p.add_argument('--out_root', required=True)
    p.add_argument('--split', required=True,
                   choices=[constants.TRAINSET, constants.VALIDSET,
                            constants.TESTSET])
    p.add_argument('--nblocks', type=int, default=1)
    p.add_argument('--process_block', type=int, default=0)
    p.add_argument('--video_ext', default='.mp4')
    a = p.parse_args(argv)
    return crop_faces_align(a.folds_dir, a.videos_root, a.out_root, a.split,
                            nblocks=a.nblocks,
                            process_block=a.process_block,
                            video_ext=a.video_ext, device=device)


if __name__ == '__main__':
    main()
