"""Feature-store integrity checker (fsck for the on-disk contract): a copy
of ``tools/validate_store.py`` on the port's modules, whose reports it
gives for the same store (``tests/test_torch_run_tools.py``).  It runs on
the host and reads no device.

The upstream ecosystem ships stores whose defects surface as crashes or
silent quality loss deep inside a run: truncated ``.npy`` shards, modality
frame counts drifting from ``dataset_info`` lengths (upstream even
hard-codes truncation fixups for 5 known-broken challenge videos in its
face compaction), fold lists referencing trials that never finished
extraction (upstream's dataset silently intersects), stale
recompacted ``video_48.npy`` files, and stores built by mixed extractor
generations.  This tool front-loads every one of those checks into a
single offline pass and emits a machine-readable report.

Usage::

    python -m fvt_tpu_torch.tools.validate_store --dataset_path /path/to/store \
        --dataset_name MELD [--folds_dir /path/to/folds/MELD --fold 0] \
        [--json report.json] [--deep] [--repair]

Exit code 0 = no errors (warnings allowed), 1 = at least one error.
With ``--repair`` the safe fixes are applied between two validation
passes (see the repair section below) and the exit code reflects the
POST-repair state; the JSON output becomes {pre, repairs, post, ok}.

Checks
------
dataset_info   pickles load; required keys present and list lengths agree;
               duplicate trials; extractor-generation stamp
               (fvt_tpu_torch/preprocess/version.py) consistent across splits.
trial dirs     exist; every ``.npy`` header parses AND the payload size on
               disk matches the header (catches truncation mid-write).
frame counts   per-frame modalities (video/vggish/bert/mfcc/egemaps/
               logmel/labels) match the recorded trial length.  For the
               C-EXPR-DB* datasets video.npy is the source of truth (the
               arranger re-reads it, data/arranger.py:55-60) so a
               length-field drift is a warning; elsewhere it is an error.
video contract (n, H, W, 3) uint8 with square H == W; recompacted
               ``video_48.npy`` must be fresh (same rows, mtime >= source)
               or it is flagged stale (the loader ignores stale files —
               data/dataset.py:68-88 — but they waste disk and signal an
               interrupted recompact).
labels         integer dtype and, when ``class_id.yaml`` is available,
               values inside the class range (ignore label allowed).
folds          class_id.yaml contiguous 0..n-1; every fold trial resolved
               in the store (missing -> warning, like upstream's
               silent intersection; an EMPTY intersection -> error).
mean/std cache ``mean_std_info_fold-*.pkl`` older than the newest
               feature npy -> stale-normalization warning (the runtime
               computes it once and never invalidates,
               experiment.py:84-95); ``--repair`` drops it.
--deep         additionally mmap-scan float features for NaN/Inf rows
               (strided sample per trial, bounded cost).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from os.path import join

import numpy as np

from fvt_tpu_torch import constants
from fvt_tpu_torch.data import folds as folds_mod
from fvt_tpu_torch.data.native_store import npy_header
from fvt_tpu_torch.preprocess.version import EXTRACTOR_VERSION, STAMP_KEY
from fvt_tpu_torch.utils.io import load_pickle, save_pickle

# per-frame streams whose row count must equal the trial length
FRAME_FEATURES = ('video', 'vggish', 'bert', 'mfcc', 'egemaps', 'logmel',
                  'cnn')
LABEL_SUFFIX = 'continuous_label'
MAX_EXAMPLES = 20  # examples kept a kind in the report


class Report:
    def __init__(self):
        self.errors: dict[str, list] = {}
        self.warnings: dict[str, list] = {}
        self.counts: dict[str, int] = {}
        self.max_npy_mtime = 0.0  # newest feature file seen (cache check)
        # per-sink tallies: a kind can be BOTH an error and a warning
        # (frame_count_mismatch is a warning for C-EXPR-DB video drift
        # but an error elsewhere), so n_errors/n_warnings must not be
        # derived from the combined counts dict
        self._n_err = 0
        self._n_warn = 0

    def _add(self, sink, kind, example):
        lst = sink.setdefault(kind, [])
        if len(lst) < MAX_EXAMPLES:
            lst.append(example)
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def error(self, kind, example):
        self._add(self.errors, kind, example)
        self._n_err += 1

    def warn(self, kind, example):
        self._add(self.warnings, kind, example)
        self._n_warn += 1

    def as_dict(self):
        return {'ok': not self.errors,
                'n_errors': self._n_err, 'n_warnings': self._n_warn,
                'counts': self.counts,
                'errors': self.errors, 'warnings': self.warnings,
                'note': f'example lists capped at {MAX_EXAMPLES} '
                        f'per issue; counts are exact'}


def _payload_ok(path):
    """Header parses and the on-disk payload matches it (truncation
    check: np.load on a short file fails only when the missing bytes are
    actually read, which for mmap is at first access deep in a run)."""
    offset, shape, dtype, _f = npy_header(path)
    expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    actual = os.path.getsize(path) - offset
    return actual == expect, shape, dtype


def _check_split_info(info, split, rep):
    required = ('trial', 'length')
    for key in required:
        if key not in info:
            rep.error('dataset_info_missing_key', f'{split}: {key}')
            return False
    if 'data_folder' not in info:
        rep.warn('dataset_info_missing_key',
                 f'{split}: data_folder (assuming compacted_48)')
    lens = {k: len(info[k]) for k in required if k in info}
    if len(set(lens.values())) > 1:
        rep.error('dataset_info_ragged_lists', f'{split}: {lens}')
        return False
    return True


def _check_trial(tdir, trial, length, ds, class_ids, rep, deep=False):
    if not os.path.isdir(tdir):
        rep.error('trial_dir_missing', trial)
        return
    npys = sorted(glob.glob(join(tdir, '*.npy')))
    if not npys:
        rep.error('trial_dir_empty', trial)
        return

    # C-EXPR-DB*: the ARRANGER re-reads video.npy as the trial-length
    # authority (data/arranger.py:55-61) — video.npy must exist, and the
    # other per-frame streams must cover ITS row count (a stream shorter
    # than video crashes the window gather at runtime even when it
    # matches the recorded length).  Elsewhere the recorded length rules.
    video_authority = ds in (constants.C_EXPR_DB,
                             constants.C_EXPR_DB_CHALLENGE)

    headers = {}
    recompacted = {}
    for path in npys:
        name = os.path.basename(path)[:-4]
        rep.max_npy_mtime = max(rep.max_npy_mtime, os.path.getmtime(path))
        try:
            ok, shape, dtype = _payload_ok(path)
        except Exception as e:
            rep.error('npy_unreadable', f'{trial}/{name}: {e}')
            continue
        if not ok:
            rep.error('npy_truncated', f'{trial}/{name}: header {shape} '
                                       f'{dtype} vs payload size')
            continue
        m = re.fullmatch(r'video_(\d+)', name)
        if m:
            recompacted[path] = (shape, int(m.group(1)))
        else:
            headers[name] = (path, shape, dtype)

    video_rows = None
    if constants.VIDEO in headers:
        _p, shape, dtype = headers[constants.VIDEO]
        video_rows = shape[0]
        if dtype != np.uint8:
            rep.error('video_dtype', f'{trial}: {dtype}')
        if len(shape) != 4 or shape[3] != 3 or shape[1] != shape[2]:
            rep.error('video_shape', f'{trial}: {shape}')
    elif video_authority:
        rep.error('video_missing',
                  f'{trial}: C-EXPR-DB* trials need video.npy — the '
                  f'arranger reads it for the trial length '
                  f'(data/arranger.py:55-61)')

    # the row count the runtime will actually gather up to
    runtime_rows = video_rows if (video_authority
                                  and video_rows is not None) else length

    for name, (path, shape, dtype) in headers.items():
        if name.endswith(LABEL_SUFFIX):
            if not np.issubdtype(dtype, np.integer) \
                    and not np.issubdtype(dtype, np.floating):
                rep.error('label_dtype', f'{trial}/{name}: {dtype}')
            elif np.issubdtype(dtype, np.integer) and class_ids \
                    and shape[0] > 0:  # empty file: frame-count check
                vals = np.load(path, mmap_mode='r')
                lo, hi = int(vals.min()), int(vals.max())
                n_cls = len(class_ids)
                if lo < -1 or hi >= n_cls:  # -1 = ignore label
                    rep.error('label_out_of_range',
                              f'{trial}/{name}: [{lo}, {hi}] vs '
                              f'{n_cls} classes')
        if name in FRAME_FEATURES or name.endswith(LABEL_SUFFIX):
            if video_authority and name == constants.VIDEO:
                # recorded-length drift is survivable (warning): the
                # arranger re-reads video.npy anyway
                if shape[0] != length:
                    rep.warn('frame_count_mismatch',
                             f'{trial}/{name}: {shape[0]} rows vs '
                             f'recorded length {length} (survivable: '
                             f'arranger trusts video.npy)')
            elif shape[0] < runtime_rows:
                rep.error('frame_count_mismatch',
                          f'{trial}/{name}: {shape[0]} rows < runtime '
                          f'length {runtime_rows} — the window gather '
                          f'will index out of range')
            elif shape[0] != runtime_rows:
                # extra rows beyond the runtime length are ignored by
                # the gather, but signal a desynced extraction
                sink = rep.warn if video_authority else rep.error
                sink('frame_count_mismatch',
                     f'{trial}/{name}: {shape[0]} rows vs runtime '
                     f'length {runtime_rows}')
        if deep and np.issubdtype(dtype, np.floating) and shape[0] > 0:
            arr = np.load(path, mmap_mode='r')
            idx = np.unique(np.linspace(0, shape[0] - 1,
                                        min(32, shape[0]), dtype=int))
            sample = np.asarray(arr[idx], dtype=np.float64)
            if not np.isfinite(sample).all():
                rep.error('nonfinite_feature', f'{trial}/{name}')

    for path, (shape, scale) in recompacted.items():
        src = join(tdir, 'video.npy')
        name = os.path.basename(path)[:-4]
        if not os.path.isfile(src):
            rep.warn('recompacted_orphan', f'{trial}/{name}')
            continue
        stale = (video_rows is not None and shape[0] != video_rows) or \
            os.path.getmtime(path) < os.path.getmtime(src)
        if stale:
            rep.warn('recompacted_stale',
                     f'{trial}/{name}: {shape[0]} rows vs video '
                     f'{video_rows} (or older mtime) — loader will '
                     f're-resize from video.npy; re-run '
                     f'preprocess/recompact.py')
        if len(shape) != 4 or shape[1] != scale or shape[2] != scale:
            rep.error('recompacted_shape', f'{trial}/{name}: {shape}')


def _check_folds(folds_dir, fold, known_trials, rep):
    split_dir = join(folds_dir, f'split-{fold}')
    if not os.path.isdir(split_dir):
        rep.error('folds_split_missing', split_dir)
        return None
    class_ids = None
    cid = join(split_dir, 'class_id.yaml')
    if os.path.isfile(cid):
        try:
            class_ids = folds_mod.load_class_id(folds_dir, fold)
            ints = sorted(class_ids.values())
            if ints != list(range(len(ints))):
                rep.error('class_id_not_contiguous', str(ints))
        except Exception as e:
            rep.error('class_id_unreadable', f'{cid}: {e}')
    else:
        rep.warn('class_id_missing', cid)
    # the arranger opens {train,val,test}.txt for EVERY dataset
    # (data/arranger.py::create_splits iterates all three split keys,
    # challenge folds alias train.txt into val/test copies), so a
    # missing one is a guaranteed prepare-time FileNotFoundError
    required = [join(split_dir, f'{s}.txt') for s in constants.SPLITS]
    for split_txt in required:
        if not os.path.isfile(split_txt):
            rep.error('fold_txt_missing', split_txt)
    for split_txt in sorted(glob.glob(join(split_dir, '*.txt'))):
        split = os.path.basename(split_txt)[:-4]
        try:
            fold_map = folds_mod.load_fold_txt(split_txt)
        except Exception as e:
            rep.error('fold_txt_unreadable', f'{split_txt}: {e}')
            continue
        if not fold_map and split in constants.SPLITS:
            # init_loaders raises on an empty split after fold filtering
            rep.error('fold_txt_empty', split_txt)
            continue
        missing = [t for t in fold_map if t not in known_trials]
        for t in missing:  # _add caps the example list, counts stay exact
            rep.warn('fold_trial_not_in_store', f'{split}: {t}')
        if fold_map and len(missing) == len(fold_map):
            rep.error('fold_split_fully_missing',
                      f'{split}: none of {len(fold_map)} trials in store')
        if class_ids:
            n_cls = len(class_ids)
            for t, v in fold_map.items():
                if not 0 <= v['cl'] < n_cls:
                    rep.error('fold_label_out_of_range',
                              f'{split}: {t}={v["cl"]}')
    return class_ids


def validate(dataset_path, dataset_name, folds_dir=None, fold=0,
             deep=False):
    rep = Report()
    feat = join(dataset_path, 'features')
    if not os.path.isdir(feat):
        rep.error('features_dir_missing', feat)
        return rep

    infos = {}
    pattern = join(feat, f'dataset_info_{dataset_name}_*.pkl')
    for path in sorted(glob.glob(pattern)):
        split = os.path.basename(path)[:-4].split('_')[-1]
        if split not in constants.SPLITS:
            # unmerged per-part shard (dataset_info_{ds}_{split}_{nparts}
            # _{part}.pkl) — run preprocess/merge.py before validating
            rep.warn('unmerged_shard', os.path.basename(path))
            continue
        try:
            infos[split] = load_pickle(path)
        except Exception as e:
            rep.error('dataset_info_unreadable', f'{path}: {e}')
    if not infos:
        rep.error('dataset_info_missing', pattern)
        return rep

    # Experiment.load_dataset_info reads a fixed per-dataset split set
    # (experiment.py:54-68); a missing pkl there is a prepare-time crash
    need = {constants.MELD: constants.SPLITS,
            constants.C_EXPR_DB: [constants.TRAINSET, constants.VALIDSET],
            constants.C_EXPR_DB_CHALLENGE: [constants.TRAINSET],
            }.get(dataset_name, [constants.TRAINSET])
    for split in need:
        if split not in infos:
            rep.error('dataset_info_split_missing',
                      f'{dataset_name} needs dataset_info_'
                      f'{dataset_name}_{split}.pkl')

    stamps = {s: i.get(STAMP_KEY) for s, i in infos.items()}
    if len(set(stamps.values())) > 1:
        rep.error('extractor_generation_mixed', str(stamps))
    for s, v in stamps.items():
        if v is None:
            rep.warn('extractor_stamp_missing',
                     f'{s}: pre-r4 store, current generation is '
                     f'{EXTRACTOR_VERSION}')
        elif v != EXTRACTOR_VERSION:
            rep.warn('extractor_generation_old',
                     f'{s}: built by generation {v}, code is '
                     f'{EXTRACTOR_VERSION}')

    known_trials = set()
    for split, info in infos.items():
        if _check_split_info(info, split, rep):
            known_trials.update(info['trial'])
    class_ids = None
    if folds_dir:
        # folds before trials so label-range checks can use class_id.yaml
        class_ids = _check_folds(folds_dir, fold, known_trials, rep)

    seen = set()
    n_trials = 0
    for split, info in infos.items():
        if 'trial' not in info or 'length' not in info:
            continue
        folder = info.get('data_folder', 'compacted_48')
        for trial, length in zip(info['trial'], info['length']):
            key = trial
            if key in seen:
                rep.error('duplicate_trial', f'{split}: {trial}')
                continue
            seen.add(key)
            n_trials += 1
            _check_trial(join(feat, folder, trial), trial, int(length),
                         dataset_name, class_ids, rep, deep=deep)
    rep.counts['trials_checked'] = n_trials

    # mean/std cache freshness: computed ONCE and never invalidated by
    # the runtime (experiment.py:84-95 returns early when the file
    # exists, mirroring upstream's base/experiment.py:247-269), so a
    # store mutated after the cache was built silently trains with
    # stale normalization stats
    for cache in sorted(glob.glob(join(dataset_path,
                                       'mean_std_info_fold-*.pkl'))):
        if rep.max_npy_mtime and \
                os.path.getmtime(cache) < rep.max_npy_mtime:
            rep.warn('mean_std_cache_stale',
                     f'{os.path.basename(cache)}: older than the newest '
                     f'feature npy — the runtime will NOT recompute it; '
                     f'delete it (or run --repair) to refresh')
    return rep


# ---------------------------------------------------------------------------
# Repair pass (--repair)
#
# Upstream ships its store fixups as hard-coded special cases for 5
# known-broken challenge videos (its face compaction truncates every
# feature to the video frame count).  The repair pass makes those
# semantics a general, safe operation:
#
#   * truncated .npy payload  -> salvage the complete leading rows
#     (rewrite as a valid file; the partial tail row is data loss that
#     already happened at write time)
#   * per-frame stream LONGER than the runtime length -> truncate to it
#     (exactly the upstream fixup, generalized)
#   * stale/orphan recompacted video_<N>.npy -> delete (the loader
#     ignores them; preprocess/recompact.py regenerates)
#   * C-EXPR-DB*: recorded dataset_info length drifting from video.npy
#     rows -> rewrite the recorded length (the arranger trusts video.npy,
#     data/arranger.py:55-61; this aligns the record with the authority)
#
# NOT repaired (data would have to be fabricated): streams SHORTER than
# the runtime length, missing video.npy on C-EXPR-DB*, label values out
# of class range, duplicate trials.  All writes are atomic
# (tmp + os.replace) because loaders mmap these files — an in-place
# rewrite would SIGBUS a concurrently-mapped process.
# ---------------------------------------------------------------------------

def _atomic_save_npy(path, arr):
    tmp = path + '.fsck_tmp.npy'  # .npy suffix: np.save appends otherwise
    np.save(tmp, np.ascontiguousarray(arr))
    os.replace(tmp, path)


def _salvage_truncated(path):
    """Rewrite a payload-truncated .npy keeping the complete leading
    rows.  Returns the new row count, or None when unsalvageable
    (fortran order, zero-size rows, or no complete row survived)."""
    offset, shape, dtype, fortran = npy_header(path)
    if fortran or len(shape) == 0:
        return None
    row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
    if row_bytes <= 0:
        return None
    payload = os.path.getsize(path) - offset
    n_complete = int(payload // row_bytes)
    if n_complete <= 0 or n_complete >= shape[0]:
        return None
    with open(path, 'rb') as f:
        f.seek(offset)
        flat = np.fromfile(f, dtype=dtype,
                           count=n_complete * (row_bytes // dtype.itemsize))
    _atomic_save_npy(path, flat.reshape((n_complete,) + tuple(shape[1:])))
    return n_complete


def _truncate_npy_rows(path, n):
    arr = np.load(path, mmap_mode='r')
    _atomic_save_npy(path, arr[:n])


def repair(dataset_path, dataset_name):
    """Apply the safe repairs described above.  Returns a list of
    repair-action records; dataset_info pickles are rewritten in place
    (atomically) when recorded lengths are realigned."""
    actions = []
    visited_dirs = set()
    feat = join(dataset_path, 'features')
    video_authority = dataset_name in (constants.C_EXPR_DB,
                                       constants.C_EXPR_DB_CHALLENGE)
    pattern = join(feat, f'dataset_info_{dataset_name}_*.pkl')
    for info_path in sorted(glob.glob(pattern)):
        split = os.path.basename(info_path)[:-4].split('_')[-1]
        if split not in constants.SPLITS:
            continue  # unmerged shard: merge first, then repair
        try:
            info = load_pickle(info_path)
        except Exception:
            continue
        if 'trial' not in info or 'length' not in info:
            continue
        folder = info.get('data_folder', 'compacted_48')
        lengths = list(info['length'])
        info_dirty = False
        for i, (trial, length) in enumerate(zip(info['trial'], lengths)):
            tdir = join(feat, folder, trial)
            if not os.path.isdir(tdir):
                continue
            if tdir not in visited_dirs:
                visited_dirs.add(tdir)
                # 0) sweep temp files orphaned by a repair that crashed
                #    between np.save(tmp) and os.replace — later passes
                #    would otherwise glob them as unknown streams forever
                for tmp in sorted(glob.glob(join(tdir, '*.fsck_tmp*'))):
                    os.remove(tmp)
                    actions.append({'action': 'removed_orphan_tmp',
                                    'file': f'{trial}/'
                                            f'{os.path.basename(tmp)}'})
            # 1) salvage truncated payloads first: later steps need
            #    readable row counts
            for path in sorted(glob.glob(join(tdir, '*.npy'))):
                name = os.path.basename(path)[:-4]
                try:
                    ok, _shape, _dtype = _payload_ok(path)
                except Exception:
                    continue
                if not ok:
                    kept = _salvage_truncated(path)
                    if kept is not None:
                        actions.append({'action': 'salvaged_truncated',
                                        'file': f'{trial}/{name}',
                                        'rows_kept': kept})

            def _rows(name):
                p = join(tdir, f'{name}.npy')
                if not os.path.isfile(p):
                    return None, None
                try:
                    ok, shape, _d = _payload_ok(p)
                except Exception:
                    return None, None
                return (shape[0] if ok else None), p

            video_rows, _vp = _rows(constants.VIDEO)
            runtime_rows = video_rows if (video_authority
                                          and video_rows is not None) \
                else int(length)

            # 2) the upstream fixup, generalized: truncate over-long
            #    per-frame streams (and labels) to the runtime length
            for path in sorted(glob.glob(join(tdir, '*.npy'))):
                name = os.path.basename(path)[:-4]
                if name not in FRAME_FEATURES \
                        and not name.endswith(LABEL_SUFFIX):
                    continue
                if video_authority and name == constants.VIDEO:
                    continue  # never truncate the authority
                rows, _p = _rows(name)
                if rows is not None and rows > runtime_rows:
                    _truncate_npy_rows(path, runtime_rows)
                    actions.append({'action': 'truncated_stream',
                                    'file': f'{trial}/{name}',
                                    'rows': f'{rows} -> {runtime_rows}'})

            # step 2 may have truncated video.npy itself (non-authority
            # datasets) — refresh the row count before the checks below
            video_rows, _vp = _rows(constants.VIDEO)

            # 3) realign the recorded length with the video authority
            if video_authority and video_rows is not None \
                    and int(length) != video_rows:
                lengths[i] = type(length)(video_rows)
                info_dirty = True
                actions.append({'action': 'realigned_recorded_length',
                                'file': f'{split}: {trial}',
                                'rows': f'{int(length)} -> {video_rows}'})

            # 4) drop stale/orphan recompacted files (loader ignores
            #    them; recompact.py regenerates)
            for path in sorted(glob.glob(join(tdir, '*.npy'))):
                name = os.path.basename(path)[:-4]
                m = re.fullmatch(r'video_(\d+)', name)
                if not m:
                    continue
                src = join(tdir, 'video.npy')
                scale = int(m.group(1))
                try:
                    ok, shape, _d = _payload_ok(path)
                except Exception:
                    ok, shape = False, ()
                bad_shape = not ok or len(shape) != 4 \
                    or shape[1] != scale or shape[2] != scale
                stale = bad_shape or (not os.path.isfile(src)) or \
                    (video_rows is not None and shape[0] != video_rows) or \
                    os.path.getmtime(path) < os.path.getmtime(src)
                if stale:
                    os.remove(path)
                    actions.append({'action': 'removed_stale_recompact',
                                    'file': f'{trial}/{name}'})
        if info_dirty:
            info['length'] = lengths
            tmp = info_path + '.fsck_tmp'
            save_pickle(info, tmp)
            os.replace(tmp, info_path)
            actions.append({'action': 'rewrote_dataset_info',
                            'file': os.path.basename(info_path)})

    # Stream mutations change the train-split feature statistics, and a
    # cache older than the newest feature file was stale to begin with —
    # either way drop it so the next run recomputes (derived data;
    # calc_mean_std defaults to true in both stacks; the runtime never
    # invalidates, experiment.py:84-95).  Mutated files carry fresh
    # mtimes, so one post-repair mtime scan covers both cases, and a
    # repair that changed nothing on a fresh store removes nothing
    # (idempotence).
    newest = 0.0
    for tdir in sorted(visited_dirs):
        for path in glob.glob(join(tdir, '*.npy')):
            newest = max(newest, os.path.getmtime(path))
    for cache in sorted(glob.glob(join(dataset_path,
                                       'mean_std_info_fold-*.pkl'))):
        if newest and os.path.getmtime(cache) < newest:
            os.remove(cache)
            actions.append({'action': 'removed_stale_mean_std_cache',
                            'file': os.path.basename(cache)})
    return actions


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--dataset_path', required=True)
    ap.add_argument('--dataset_name', required=True,
                    choices=constants.DATASETS)
    ap.add_argument('--folds_dir', default=None,
                    help='folds/<ds> dir; enables fold cross-checks')
    ap.add_argument('--fold', type=int, default=0)
    ap.add_argument('--deep', action='store_true',
                    help='NaN/Inf scan of float features (strided sample)')
    ap.add_argument('--repair', action='store_true',
                    help='apply safe repairs (truncate over-long streams, '
                         'salvage truncated .npy, drop stale recompacts, '
                         'realign C-EXPR-DB* recorded lengths), then '
                         're-validate')
    ap.add_argument('--json', default=None, help='write the report here')
    args = ap.parse_args(argv)

    rep = validate(args.dataset_path, args.dataset_name,
                   folds_dir=args.folds_dir, fold=args.fold,
                   deep=args.deep)
    out = rep.as_dict()
    if args.repair:
        actions = repair(args.dataset_path, args.dataset_name)
        post = validate(args.dataset_path, args.dataset_name,
                        folds_dir=args.folds_dir, fold=args.fold,
                        deep=args.deep).as_dict()
        out = {'pre': out, 'repairs': actions, 'post': post,
               'ok': post['ok']}
    print(json.dumps(out, indent=2, sort_keys=True))
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=2, sort_keys=True)
    return 0 if out['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
