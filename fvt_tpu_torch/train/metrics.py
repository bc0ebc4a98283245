"""Frame- and video-level classification metrics + best-model tracking:
a copy of ``fvt_tpu/train/metrics.py`` (numpy only), held equal to it by
``tests/test_torch_copies.py``, with the regression task's
``compute_regression_perf`` (``tests/test_torch_regression.py``).

Pure-numpy re-implementation of the upstream metric engine
(its metrics.py:43-462).  Behavioral contract:

* ``format_trg_pred_frames`` / ``format_trg_pred_video`` turn the
  per-video ``{'labels', 'logits'}`` dict into flat target/pred lists,
  optionally dropping the 'Other' class (id 7): its logits column is
  removed before argmax and its frames/videos are skipped.
* three frame->video aggregation rules are computed in one pass:
  majority vote, average probs, average logits.
* F1 follows sklearn semantics: per-class scores over the sorted union of
  labels seen in targets or predictions; macro = unweighted mean; weighted
  = support-weighted mean; zero-division -> 0.
* ``PerfTracker`` tracks one master scalar, `>=` counts as a new best.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np

from fvt_tpu_torch import constants


def softmax(x: np.ndarray) -> np.ndarray:
    """Row softmax, bit-identical to the reference (metrics.py:43-48)
    for every sane logit, with a guarded max-shift ONLY for rows whose
    exp would overflow (float32 inf above ~88.7): an unshifted overflow
    row becomes inf/inf = NaN and argmax silently returns class 0,
    corrupting the FRAMES_AVG_PROBS aggregation.  For rows with
    max <= 80 the shift is exactly 0.0, so ``x - shift`` is the same
    array and parity is preserved bitwise."""
    assert x.ndim == 2, x.ndim
    m = np.max(x, axis=1, keepdims=True)
    shift = np.where(m > 80.0, m, x.dtype.type(0.0))
    _exp = np.exp(x - shift)
    return _exp / np.sum(_exp, axis=1).reshape((-1, 1))


def _check_ignore(ignore_class) -> bool:
    if isinstance(ignore_class, int):
        assert ignore_class == 7, ignore_class  # 'Other' is the last class
        return True
    return False


def format_trg_pred_frames(data: dict, ignore_class: Optional[int]
                           ) -> Tuple[list, list]:
    """Flatten per-video frame logits into (preds, targets) lists."""
    limited = _check_ignore(ignore_class)

    preds: List[int] = []
    trgs: List[int] = []
    for _id in data:
        labels = np.asarray(data[_id]['labels']).tolist()
        logits = np.asarray(data[_id]['logits'])
        assert logits.ndim == 2, logits.ndim
        if limited:
            logits = logits[:, :-1]

        p = np.argmax(logits, axis=1).flatten().tolist()
        assert len(p) == len(labels), f"{len(p)} | {len(labels)}"

        for i, l in enumerate(labels):
            if limited and l == ignore_class:
                continue
            trgs.append(l)
            preds.append(p[i])

    return preds, trgs


def format_trg_pred_video(data: dict, ignore_class: Optional[int]
                          ) -> Tuple[list, list]:
    """Per-video (pred-dict, target) pairs under the three aggregation rules.

    Each video is assumed single-label (all frame labels equal).
    """
    limited = _check_ignore(ignore_class)

    preds: List[dict] = []
    trgs: List[int] = []
    for _id in data:
        labels = np.asarray(data[_id]['labels'])
        unique = np.unique(labels).tolist()
        assert len(unique) == 1, len(unique)
        label = unique[0]

        if limited and label == ignore_class:
            continue

        logits = np.asarray(data[_id]['logits'])
        assert logits.ndim == 2, logits.ndim
        if limited:
            logits = logits[:, :-1]

        frame_preds = np.argmax(logits, axis=1).flatten()

        # majority vote; ties broken by first-encountered order, as Counter
        # .most_common does in the reference (metrics.py:124-125).
        vals, first_pos, cnts = np.unique(
            frame_preds, return_index=True, return_counts=True)
        order = np.lexsort((first_pos, -cnts))
        vote = int(vals[order[0]])

        avg_logits_pred = int(np.argmax(logits.mean(axis=0)))
        avg_probs_pred = int(np.argmax(softmax(logits).mean(axis=0)))

        trgs.append(label)
        preds.append({
            constants.FRM_VOTE: vote,
            constants.FRM_AVG_LOGITS: avg_logits_pred,
            constants.FRM_AVG_PROBS: avg_probs_pred,
        })

    return preds, trgs


def _per_class_f1(trgs: np.ndarray, preds: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class F1 over sorted union of observed labels (sklearn semantics).

    Returns (f1_per_class, support_per_class, labels).
    """
    labels = np.unique(np.concatenate([trgs, preds]))
    f1 = np.zeros(len(labels), dtype=np.float64)
    support = np.zeros(len(labels), dtype=np.int64)
    for i, c in enumerate(labels):
        tp = np.sum((preds == c) & (trgs == c))
        fp = np.sum((preds == c) & (trgs != c))
        fn = np.sum((preds != c) & (trgs == c))
        denom = 2 * tp + fp + fn
        f1[i] = (2.0 * tp / denom) if denom > 0 else 0.0
        support[i] = np.sum(trgs == c)
    return f1, support, labels


def compute_f1_score(trgs: list, preds: list, f1_type: str
                     ) -> Tuple[np.ndarray, float]:
    """(per-class F1, aggregated F1); aggregation per ``f1_type``."""
    assert f1_type in [constants.W_F1, constants.MACRO_F1], f1_type
    t = np.asarray(trgs)
    p = np.asarray(preds)
    f1_s, support, _ = _per_class_f1(t, p)

    if f1_type == constants.MACRO_F1:
        return f1_s, float(np.mean(f1_s))

    total = support.sum()
    w_f1 = float(np.sum(f1_s * support) / total) if total > 0 else 0.0
    return f1_s, w_f1


def _f1_both(trgs: list, preds: list) -> Tuple[np.ndarray, float, float]:
    """(per-class F1, macro F1, weighted F1) from ONE per-class pass —
    compute_perf needs both aggregations of the same arrays."""
    f1_s, support, _ = _per_class_f1(np.asarray(trgs), np.asarray(preds))
    total = support.sum()
    w_f1 = float(np.sum(f1_s * support) / total) if total > 0 else 0.0
    return f1_s, float(np.mean(f1_s)), w_f1


def compute_class_acc(trgs: list, preds: list) -> float:
    t = np.array(trgs, dtype=np.float32)
    p = np.array(preds, dtype=np.float32)
    return float(((p == t) * 1.0).mean() * 100.0)


def compute_confusion_matrix(trgs: list, preds: list) -> np.ndarray:
    """Row-normalized confusion matrix over the sorted union of labels."""
    t = np.asarray(trgs)
    p = np.asarray(preds)
    labels = np.unique(np.concatenate([t, p]))
    n = len(labels)
    lut = {c: i for i, c in enumerate(labels.tolist())}
    mtx = np.zeros((n, n), dtype=np.float64)
    t_idx = np.searchsorted(labels, t)
    p_idx = np.searchsorted(labels, p)
    np.add.at(mtx, (t_idx, p_idx), 1.0)
    row = mtx.sum(axis=1, keepdims=True)
    with np.errstate(invalid='ignore'):
        mtx = mtx / row
    return mtx


def compute_perf(data: dict, dataset_name: str, use_other_class: bool,
                 other_int: int = 7) -> dict:
    """The full nested perf dict (reference trainer.py:525-605).

    Layout: ``perf[ignore_class][metric][level](...)['master'|'per_cl']``.
    """
    _atom = {'master': 0.0, 'per_cl': 0.0}
    _video = {k: copy.deepcopy(_atom) for k in constants.VIDEO_PREDS}
    perf_tpl = {
        mtr: {
            constants.FRAME_LEVEL: copy.deepcopy(_atom),
            constants.VIDEO_LEVEL: copy.deepcopy(_video),
        } for mtr in constants.METRICS
    }

    l_ignore_class: List[Optional[int]] = [None]
    if dataset_name == constants.C_EXPR_DB and use_other_class:
        assert other_int == 7, other_int
        l_ignore_class.append(other_int)

    all_perf = {}
    for ignore_class in l_ignore_class:
        _perf = copy.deepcopy(perf_tpl)

        preds, trgs = format_trg_pred_frames(data, ignore_class=ignore_class)
        if len(trgs) == 0:
            # raise BEFORE the degenerate means below emit numpy
            # empty-slice RuntimeWarnings on the way to the same error
            raise ValueError(
                f"compute_perf: every frame in the eval set carries the "
                f"ignored class ({ignore_class}); no metrics can be "
                f"computed. Check the split or disable use_other_class. "
                f"(The reference crashes with an IndexError here: "
                f"the upstream metrics.py:89-145.)")
        f1_per_cl, macro_f1, w_f1 = _f1_both(trgs, preds)
        acc = compute_class_acc(trgs, preds)
        cnf = compute_confusion_matrix(trgs, preds)

        _perf[constants.MACRO_F1][constants.FRAME_LEVEL] = {
            'master': macro_f1, 'per_cl': f1_per_cl}
        _perf[constants.W_F1][constants.FRAME_LEVEL] = {
            'master': w_f1, 'per_cl': f1_per_cl}
        _perf[constants.CL_ACC][constants.FRAME_LEVEL] = {
            'master': acc, 'per_cl': acc}
        _perf[constants.CFUSE_MARIX][constants.FRAME_LEVEL] = {
            'master': cnf, 'per_cl': cnf}

        preds, trgs = format_trg_pred_video(data, ignore_class=ignore_class)
        if not preds:
            raise ValueError(
                f"compute_perf: every video in the eval set carries the "
                f"ignored class ({ignore_class}); no video-level metrics can "
                f"be computed. Check the split or disable use_other_class. "
                f"(The reference crashes with an IndexError here: "
                f"the upstream metrics.py:89-145.)")
        for k in preds[0]:
            preds_k = [item[k] for item in preds]
            f1_per_cl, macro_f1, w_f1 = _f1_both(trgs, preds_k)
            acc = compute_class_acc(trgs, preds_k)
            cnf = compute_confusion_matrix(trgs, preds_k)

            _perf[constants.MACRO_F1][constants.VIDEO_LEVEL][k] = {
                'master': macro_f1, 'per_cl': f1_per_cl}
            _perf[constants.W_F1][constants.VIDEO_LEVEL][k] = {
                'master': w_f1, 'per_cl': f1_per_cl}
            _perf[constants.CL_ACC][constants.VIDEO_LEVEL][k] = {
                'master': acc, 'per_cl': acc}
            _perf[constants.CFUSE_MARIX][constants.VIDEO_LEVEL][k] = {
                'master': cnf, 'per_cl': cnf}

        all_perf[ignore_class] = _perf

    return all_perf


def _iter_masters(data: dict):
    """Yield (ignore_class, metric, level, video_pred, value) master entries."""
    for ignore_class in data:
        for metric in data[ignore_class]:
            for level in data[ignore_class][metric]:
                node = data[ignore_class][metric][level]
                if level == constants.FRAME_LEVEL:
                    yield ignore_class, metric, level, None, node['master']
                else:
                    for video_pred in node:
                        yield (ignore_class, metric, level, video_pred,
                               node[video_pred]['master'])


class PerfTracker:
    """Tracks one master scalar across epochs; `>=` updates the best.

    Mirrors upstream metrics.py:196-462 (holder list, is_last_best,
    status strings) without the nested deep-copy machinery.
    """

    def __init__(self,
                 master_ignore_class=None,
                 master_metric=constants.MACRO_F1,
                 master_level=constants.FRAME_LEVEL,
                 master_video_pred=constants.FRM_VOTE):
        self.first = True
        self.holder_list: list = []

        self.master_ignore_class = master_ignore_class
        self.master_metric = master_metric
        self.master_level = master_level
        self.master_video_pred = master_video_pred
        self.best_value = None
        self.best_value_idx = 0

        self.cnt = 0
        self.is_last_best = False
        self.current_status_str = 'None'
        self.best_status_str = 'None'

    def is_master(self, ignore_class, metric, level, video_pred) -> bool:
        cnd = ignore_class == self.master_ignore_class
        cnd &= metric == self.master_metric
        cnd &= level == self.master_level
        if level == constants.VIDEO_LEVEL:
            cnd &= video_pred == self.master_video_pred
        return cnd

    def _master_value(self, data: dict):
        for ic, metric, level, vp, value in _iter_masters(data):
            if self.is_master(ic, metric, level, vp):
                return value
        raise KeyError('master entry not found in perf dict')

    def append(self, data: dict):
        value = self._master_value(data)
        tag = (f"{self.master_ignore_class}, {self.master_metric}, "
               f"{self.master_level}"
               + (f", {self.master_video_pred}"
                  if self.master_level == constants.VIDEO_LEVEL else ''))

        if self.first:
            self.first = False
            self.holder_list = [data]
            self.cnt = 0
            self.is_last_best = True
            self.best_value = value
            self.best_value_idx = 0
            msg = f"MASTER: {tag}: {value:.6f}"
            self.current_status_str = msg
            self.best_status_str = msg
            return 0

        self.cnt += 1
        self.holder_list.append(data)
        is_best = False
        if value >= self.best_value:
            self.best_value = value
            self.best_value_idx = self.cnt
            is_best = True

        self.current_status_str = (
            f"Current MASTER: {tag}: {value:.6f} (EP. {self.cnt - 1})")
        self.best_status_str = (
            f"BEST MASTER: {tag}: {self.best_value:.6f} "
            f"(EP. {self.best_value_idx - 1})")
        self.is_last_best = is_best

    def report(self, data: dict, int_to_cl: Dict[int, str]) -> str:
        """Human-readable report of one perf dict, with texttable-style
        per-class / confusion tables (reference metrics.py:281-374 +
        tools.py:18-70)."""
        from fvt_tpu_torch.utils.tables import (print_confusion_mtx,
                                                print_vector)

        msg = ''
        for ic, metric, level, vp, value in _iter_masters(data):
            head = f"{ic}, {metric}, {level}" + (f", {vp}" if vp else '')
            if metric in (constants.CL_ACC, constants.MACRO_F1,
                          constants.W_F1):
                c_msg = f"{head}: {value:.8f}"
                if metric == constants.CL_ACC:
                    c_msg += '%'
            elif metric == constants.CFUSE_MARIX:
                c_msg = f"{head}:\n {print_confusion_mtx(value, int_to_cl)}"
            else:
                continue
            if self.is_master(ic, metric, level, vp):
                c_msg = f"Master: {c_msg}"
            msg = f"{msg}\n{c_msg}\n"

            node = data[ic][metric][level]
            per_cl = (node['per_cl'] if level == constants.FRAME_LEVEL
                      else node[vp]['per_cl'])
            if metric == constants.MACRO_F1 and isinstance(
                    per_cl, np.ndarray):
                msg = (f"{msg}\n{head}:\n "
                       f"{print_vector(per_cl, int_to_cl)}\n")
        return msg

    def master_series(self) -> list:
        """Master-metric value per appended epoch."""
        return [float(self._master_value(d)) for d in self.holder_list]

    def plot(self, wfp: str, loss_tracker=None) -> bool:
        """Master-metric-vs-epoch curve with the best epoch marked
        (+ optional train loss on a twin axis) — the classification
        analogue of the reference's tracker plots (tools.py:148-241,
        unused in its live path).  No-ops without matplotlib."""
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
        except ImportError:
            return False
        vals = self.master_series()
        if not vals:
            return False
        fig, ax1 = plt.subplots(1, 1, figsize=(5, 2.5), dpi=200)
        xs = list(range(len(vals)))
        ax1.plot(xs, vals, color='tab:blue', linewidth=1.0,
                 label='valid master')
        ax1.scatter([self.best_value_idx], [vals[self.best_value_idx]],
                    color='tab:red', s=12, zorder=3,
                    label=f'best (ep {self.best_value_idx - 1})')
        ax1.set_xlabel('epoch (+1: index 0 is the pre-train eval)',
                       fontsize=7)
        ax1.set_ylabel(f'{self.master_metric} @ {self.master_level}',
                       fontsize=7)
        ax1.tick_params(labelsize=6)
        if loss_tracker:
            ax2 = ax1.twinx()
            ax2.plot(range(1, len(loss_tracker) + 1), loss_tracker,
                     color='tab:gray', linewidth=0.6, linestyle='dashed',
                     alpha=0.6, label='train loss')
            ax2.set_ylabel('train loss', fontsize=7)
            ax2.tick_params(labelsize=6)
        ax1.legend(fontsize=6, loc='best')
        fig.tight_layout()
        fig.savefig(wfp)
        plt.close(fig)
        return True


def compute_regression_perf(data: dict) -> dict:
    """rmse / pcc / ccc over the concatenated per-video continuous outputs,
    the regression task's metrics (``fvt_tpu/train/metrics.py:427-446``).

    data: {video_id: {'labels': (T,), 'preds': (T,)}}.
    """
    from fvt_tpu_torch.train.losses import ccc_score

    golds = np.concatenate([np.asarray(v['labels'], np.float64).ravel()
                            for v in data.values()])
    preds = np.concatenate([np.asarray(v['preds'], np.float64).ravel()
                            for v in data.values()])
    rmse = float(np.sqrt(np.mean((golds - preds) ** 2)))
    if golds.std() > 0 and preds.std() > 0:
        pcc = float(np.corrcoef(golds, preds)[0, 1])
    else:
        pcc = 0.0
    return {'rmse': rmse, 'pcc': pcc, 'ccc': ccc_score(golds, preds)}


def build_trackers(dataset_name: str, use_other_class: bool,
                   other_int: int = 7) -> Dict[object, PerfTracker]:
    """Model-selection tracker set per dataset (trainer.py:636-674)."""
    trackers: Dict[object, PerfTracker] = {}
    if dataset_name in (constants.C_EXPR_DB, constants.C_EXPR_DB_CHALLENGE):
        l_ignore: List[Optional[int]] = [None]
        if dataset_name == constants.C_EXPR_DB and use_other_class:
            assert other_int == 7, other_int
            l_ignore.append(other_int)
        for ignore_class in l_ignore:
            trackers[ignore_class] = PerfTracker(
                master_ignore_class=ignore_class,
                master_metric=constants.W_F1,
                master_level=constants.FRAME_LEVEL,
                master_video_pred=None)
    elif dataset_name == constants.MELD:
        for video_pred in constants.VIDEO_PREDS:
            trackers[video_pred] = PerfTracker(
                master_ignore_class=None,
                master_metric=constants.W_F1,
                master_level=constants.VIDEO_LEVEL,
                master_video_pred=video_pred)
    else:
        raise NotImplementedError(dataset_name)
    return trackers
