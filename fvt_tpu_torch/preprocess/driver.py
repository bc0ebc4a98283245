"""Offline feature-extraction driver: sharded per-trial pipeline; the
port of ``fvt_tpu/preprocess/driver.py``.

The upstream's project/abaw5/preprocessing.py:27-639 +
base/preprocessing.py:51-1084.  Per (dataset, split, part/nparts) shard:

  1. read fold txt -> trial list; select shard ``part`` of ``nparts``
     via mit.divide semantics (preprocessing.py:121-149);
  2. per trial: probe fps/frame-count (``ffprobe``; injectable as
     ``probe``), compute annotated indices, run the extractor chain
     (label broadcast, wav conversion, log-mel, VGGish embeddings, MFCC,
     eGeMAPS, ArcFace ``cnn.npy``, 68-pt landmarks, BERT embeddings +
     frame alignment), writing the per-trial
     ``<npy_folder>/<trial>/<feature>.npy`` store;
  3. write ``dataset_info_{ds}_{split}_{nparts}_{part}.pkl`` and
     ``processing_records_{ds}_{split}_{nparts}_{part}.pkl`` shards
     (merged by fvt_tpu_torch.preprocess.merge).

The extractors are the port's: ``audio`` (log-mel patches and the VGGish
on the card), ``mfcc``/``egemaps`` (host), ``visual`` (the ArcFace on the
card) and ``fan`` (the 2D-FAN-4 on the card), all on ``device`` (None:
the card).  Each is gated on its external dependency (ffmpeg, HF BERT
weights, weight files); missing ones are skipped with a record entry,
mirroring the upstream's hasattr-gated chain (base/preprocessing.py:159).
"""
from __future__ import annotations

import argparse
import os
from fractions import Fraction
from os.path import join
from typing import Dict, List, Optional

import numpy as np

from fvt_tpu_torch import constants
from fvt_tpu_torch.data.folds import load_fold_txt
from fvt_tpu_torch.models.arcface import VisualBackbone
from fvt_tpu_torch.models.vggish import VGGish
from fvt_tpu_torch.preprocess import audio as audio_mod
from fvt_tpu_torch.preprocess import textalign
from fvt_tpu_torch.preprocess.faces import ffprobe_stream
from fvt_tpu_torch.preprocess.sharding import divide, annotated_index
from fvt_tpu_torch.train.steps import resolve_device
from fvt_tpu_torch.utils.io import save_pickle
from fvt_tpu_torch.utils.logger import log

NPY_FOLDER = 'compacted_48'
VIDEO_SIZE = 256


def probe_video(path: str):
    """(fps, n_frames) via ffprobe (preprocessing.py:209-324): fps from
    the stream's ``r_frame_rate``, the count from its ``nb_frames``, or
    from its counted packets where the container has none; corrupted
    videos raise IOError and are recorded as issues."""
    stream = ffprobe_stream(path, '-show_entries',
                            'stream=r_frame_rate,nb_frames')
    try:
        fps = float(Fraction(stream.get('r_frame_rate', '0/1')))
    except (ValueError, ZeroDivisionError):
        fps = 0.0
    n = stream.get('nb_frames', '')
    if not str(n).isdigit():
        n = ffprobe_stream(path, '-count_packets', '-show_entries',
                           'stream=nb_read_packets').get('nb_read_packets',
                                                         '0')
    n = int(n) if str(n).isdigit() else 0
    if fps <= 0 or n <= 0:
        raise IOError(f'bad fps/frame-count for {path}: {fps}/{n}')
    return fps, n


class PreprocessingDriver:
    def __init__(self, ds: str, split: str, part: int, nparts: int,
                 video_root: str, output_root: str, folds_dir: str,
                 fold: int = 0,
                 vggish: Optional[VGGish] = None,
                 bert=None,
                 arcface: Optional[VisualBackbone] = None,
                 transcriber=None,
                 text_embedder=None,
                 extract_mfcc: bool = False,
                 extract_egemaps: bool = False,
                 landmarker=None,
                 probe=probe_video,
                 device=None):
        self.device = resolve_device(device)
        self.ds = ds
        self.split = split
        self.part = part
        self.nparts = nparts
        self.video_root = video_root
        self.output_root = output_root
        self.folds_dir = folds_dir
        self.fold = fold
        self.vggish = vggish  # the port's VGGish on the device, or None
        self.bert = bert  # (tokenizer, model) or None
        self.arcface = arcface  # a VisualBackbone on the device, or None
        # probe: video path -> (fps, n_frames), raising IOError
        self.probe = probe
        # transcriber: wav_path -> transcript text, run (then punctuation-
        # restored) for trials with NO fold transcript, like the upstream
        # chain (base/preprocessing.py:381-415 -> base/speech.py:63-182);
        # injectable (Vosk via textalign.make_vosk_transcriber when its
        # package is present)
        self.transcriber = transcriber
        # text_embedder: transcript -> (n_tokens, 768); defaults to the
        # BERT sum-last-4 extractor over self.bert
        if text_embedder is None and bert is not None:
            text_embedder = lambda tx: textalign.extract_word_embedding(  # noqa: E731
                tx, bert[0], bert[1])
        self.text_embedder = text_embedder
        # optional audio features, off by default like the upstream
        # (project/abaw5/configs.py:146-148 gates extract_mfcc /
        # extract_egemaps to 0 — "can be really slow to extract")
        self.extract_mfcc = extract_mfcc
        self.extract_egemaps = extract_egemaps
        # landmarker: cropped-face RGB uint8 -> (68, 2) float32 (or None
        # on failure); gates the landmark.npy chain step
        # (base/preprocessing.py:631-648). Injectable; the CLI wires the
        # port's 2D-FAN-4 when --landmarks is passed.
        self.landmarker = landmarker

        os.makedirs(join(output_root, 'features', NPY_FOLDER),
                    exist_ok=True)

    # ------------------------------------------------------------- trials
    def task_trial_list(self) -> List[dict]:
        path_fold = join(self.folds_dir, f'split-{self.fold}',
                         f'{self.split}.txt')
        fold = load_fold_txt(path_fold)
        trials = [{'trial': t, 'label': v['cl'], 'transcript': v['txt'],
                   'subject_no': i}  # GLOBAL id, assigned before the
                  # shard split so merged dataset_info stays unique
                  # (upstream preprocessing.py numbers then divides)
                  for i, (t, v) in enumerate(fold.items())]
        shard = divide(self.nparts, trials)[self.part]
        log(f"shard {self.part}/{self.nparts}: {len(shard)} of "
            f"{len(trials)} trials")
        return shard

    def video_path(self, trial: str) -> str:
        for ext in ('.mp4', '.avi', '.mkv', ''):
            p = join(self.video_root, trial + ext)
            if os.path.isfile(p):
                return p
        raise FileNotFoundError(trial)

    # ------------------------------------------------------------ per-trial
    def process_trial(self, info: dict) -> dict:
        trial = info['trial']
        record: Dict[str, object] = {'trial': trial, 'issues': []}
        tdir = join(self.output_root, 'features', NPY_FOLDER, trial)
        os.makedirs(tdir, exist_ok=True)

        try:
            vpath = self.video_path(trial)
            fps, n_frames = self.probe(vpath)
        except (FileNotFoundError, IOError, ImportError) as e:
            record['issues'].append(f'video probe failed: {e}')
            return record

        record.update({'fps': fps, 'length': n_frames, 'path': vpath})
        ann_idx = annotated_index(n_frames, fps)

        # 1. label broadcast (project preprocessing.py:395-429)
        label_path = join(tdir, f'{constants.EXPR}.npy')
        if not os.path.isfile(label_path):
            labels = np.full((n_frames,), info['label'], dtype=np.int64)
            np.save(label_path, labels)
        record['label'] = info['label']

        # 2. audio: wav conversion + log-mel + vggish
        wav_path = join(self.output_root, 'features', 'wav', trial + '.wav')
        try:
            if audio_mod.has_ffmpeg():
                audio_mod.convert_video_to_wav(vpath, wav_path)
            if os.path.isfile(wav_path):
                logmel_path = join(tdir, 'logmel.npy')
                audio_mod.extract_logmel(
                    wav_path, logmel_path, window_sec=0.96,
                    hop_sec=1.0 / fps, annotated_idx=ann_idx,
                    device=self.device)
                if self.vggish is not None:
                    vggish_path = join(tdir, 'vggish.npy')
                    if not os.path.isfile(vggish_path):
                        emb = audio_mod.extract_vggish_embeddings(
                            wav_path, self.vggish,
                            window_sec=0.96, hop_sec=1.0 / fps,
                            annotated_idx=ann_idx, device=self.device)
                        np.save(vggish_path, emb.astype(np.float32))
            else:
                record['issues'].append('no wav (ffmpeg missing?)')
        except Exception as e:  # degrade per-sample, keep going
            record['issues'].append(f'audio failed: {e}')

        # 2a. optional audio features (gated like the upstream chain:
        # base/preprocessing.py extract_mfcc/extract_egemaps steps)
        if os.path.isfile(wav_path):
            from fvt_tpu_torch.preprocess import mfcc as mfcc_mod
            if self.extract_mfcc:
                try:
                    mfcc_mod.extract_mfcc(
                        wav_path, join(tdir, 'mfcc.npy'),
                        annotated_idx=ann_idx, hop_sec=1.0 / fps)
                except Exception as e:
                    record['issues'].append(f'mfcc failed: {e}')
            if self.extract_egemaps:
                try:
                    mfcc_mod.extract_egemaps(
                        wav_path, join(tdir, 'egemaps.npy'),
                        length=n_frames, target_frequency=fps,
                        annotated_idx=ann_idx)
                except Exception as e:
                    record['issues'].append(f'egemaps failed: {e}')

        # 2b. visual: precomputed ArcFace embeddings from compacted faces
        try:
            if self.arcface is not None and \
                    os.path.isfile(join(tdir, 'video.npy')):
                from fvt_tpu_torch.preprocess.visual import extract_cnn_to_npy
                extract_cnn_to_npy(tdir, self.arcface, device=self.device)
        except Exception as e:
            record['issues'].append(f'cnn failed: {e}')

        # 2c. 68-pt landmarks per compacted face frame -> landmark.npy
        # (upstream chain step extract_facial_landmark_fn,
        # base/preprocessing.py:631-648: the FacenetController csv's
        # cols 5..141 are x_0..x_67 then y_0..y_67 in the CROPPED-face
        # frame, zeros((68, 2)) when detection fails — video.py:249-292).
        # video.npy rows are already annotated-index aligned, so rows
        # map 1:1.
        try:
            lm_path = join(tdir, 'landmark.npy')
            if self.landmarker is not None and not os.path.isfile(lm_path) \
                    and os.path.isfile(join(tdir, 'video.npy')):
                faces = np.load(join(tdir, 'video.npy'), mmap_mode='r')
                rows = np.zeros((faces.shape[0], 136), np.float32)
                for i in range(faces.shape[0]):
                    try:
                        lm = self.landmarker(np.asarray(faces[i]))
                    except Exception:
                        lm = None  # per-frame degradation: zeros row
                    if lm is not None:
                        lm = np.asarray(lm, np.float32)
                        assert lm.shape == (68, 2), lm.shape
                        rows[i, :68] = lm[:, 0]
                        rows[i, 68:] = lm[:, 1]
                np.save(lm_path, rows)
        except Exception as e:
            record['issues'].append(f'landmarks failed: {e}')

        # 3. text: [transcribe -> punctuation ->] embedding -> alignment
        # (chain order of base/preprocessing.py:381-415)
        try:
            bert_path = join(tdir, 'bert.npy')
            if not os.path.isfile(bert_path):
                transcript = info['transcript']
                if not transcript.strip() and self.transcriber is not None \
                        and os.path.isfile(wav_path):
                    transcript = textalign.add_punctuation(
                        self.transcriber(wav_path))
                    record['transcript'] = transcript
                if self.text_embedder is not None and transcript.strip():
                    emb = np.asarray(self.text_embedder(transcript),
                                     dtype=np.float32)
                else:
                    emb = np.zeros((0, 768), dtype=np.float32)
                aligned = textalign.align_word_embedding_new(emb, ann_idx)
                np.save(bert_path, aligned)
        except Exception as e:
            record['issues'].append(f'text failed: {e}')

        return record

    # ---------------------------------------------------------------- run
    def run(self) -> List[dict]:
        from fvt_tpu_torch.preprocess.version import EXTRACTOR_VERSION, stamp

        shard = self.task_trial_list()
        records = []
        dataset_info = stamp({'trial': [], 'trial_no': [],
                              'subject_no': [],
                              'length': [], 'partition': [],
                              'pseudo_partition': [],
                              'data_folder': NPY_FOLDER})
        for i, info in enumerate(shard):
            record = self.process_trial(info)
            record['extractor_version'] = EXTRACTOR_VERSION
            records.append({'processing_record': record})
            if 'length' in record:
                dataset_info['trial'].append(record['trial'])
                dataset_info['trial_no'].append(1)
                dataset_info['subject_no'].append(
                    info.get('subject_no', i))
                dataset_info['length'].append(record['length'])
                dataset_info['partition'].append(self.split)
                dataset_info['pseudo_partition'].append(self.split)

        feat = join(self.output_root, 'features')
        tag = f'{self.ds}_{self.split}_{self.nparts}_{self.part}'
        save_pickle(dataset_info, join(feat, f'dataset_info_{tag}.pkl'))
        save_pickle(records, join(feat, f'processing_records_{tag}.pkl'))
        log(f"shard done: {len(records)} trials, "
            f"{len(dataset_info['trial'])} ok")
        return records


def main(argv=None, device=None):
    p = argparse.ArgumentParser(
        description='fvt_tpu_torch feature extraction')
    p.add_argument('--dataset_name', required=True)
    p.add_argument('--split', required=True)
    p.add_argument('--part', type=int, default=0)
    p.add_argument('--nparts', type=int, default=1)
    p.add_argument('--video_root', required=True)
    p.add_argument('--output_root', required=True)
    p.add_argument('--folds_dir', required=True)
    p.add_argument('--fold', type=int, default=0)
    p.add_argument('--vggish_pth', default=None,
                   help='upstream vggish.pth for the VGGish embeddings')
    p.add_argument('--arcface_pth', default=None,
                   help='upstream res50_ir_*.pth for cnn.npy')
    p.add_argument('--with_bert', action='store_true')
    p.add_argument('--transcribe', action='store_true',
                   help='Vosk-transcribe (+punctuate) trials that have no '
                        'fold transcript before BERT embedding')
    p.add_argument('--vosk_model_dir', default=None)
    p.add_argument('--mfcc', action='store_true',
                   help='extract 39-d HTK-chain MFCC per annotated frame '
                        '(upstream extract_mfcc step, off by default)')
    p.add_argument('--egemaps', action='store_true',
                   help='extract 88-d eGeMAPSv02 functionals per '
                        'annotated frame (upstream extract_egemaps '
                        'step, off by default)')
    p.add_argument('--landmarks', action='store_true',
                   help='write 136-d landmark.npy per compacted face '
                        'frame via the 2D-FAN-4 (upstream '
                        'extract_facial_landmark step, off by default; '
                        'needs the 2DFAN4 weight file)')
    args = p.parse_args(argv)
    device = resolve_device(device)

    vggish = (audio_mod.vggish_from_pth(args.vggish_pth, device=device)
              if args.vggish_pth else None)

    arcface = None
    if args.arcface_pth:
        from fvt_tpu_torch.preprocess.visual import backbone_from_pth
        arcface = backbone_from_pth(args.arcface_pth, device=device)

    bert = None
    if args.with_bert:
        tokenizer, model = textalign.load_bert()
        bert = (tokenizer, model.to(device))
    transcriber = (textalign.make_vosk_transcriber(args.vosk_model_dir)
                   if args.transcribe else None)

    landmarker = None
    if args.landmarks:
        from fvt_tpu_torch.preprocess.fan import make_full_frame_landmarker
        landmarker = make_full_frame_landmarker(device=device)

    driver = PreprocessingDriver(
        args.dataset_name, args.split, args.part, args.nparts,
        args.video_root, args.output_root, args.folds_dir, args.fold,
        vggish=vggish, bert=bert, arcface=arcface,
        transcriber=transcriber,
        extract_mfcc=args.mfcc, extract_egemaps=args.egemaps,
        landmarker=landmarker, device=device)
    return driver.run()


if __name__ == '__main__':
    main()
