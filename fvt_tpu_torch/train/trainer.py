"""The training and evaluation runtime of the port, a part of
``fvt_tpu/train/trainer.py``: epochs of optimizer steps over window
batches, the per-epoch learning-rate schedule and the finite-loss guard;
and ``inference``, the eval pass over a store's videos that validation,
test and challenge inference run (``trainer.py:412-704``).  The run loop
with validation and best models (``optimize``) and checkpoints are not
ported yet.
"""
from __future__ import annotations

import math
import os
import pickle as pkl
import time
from collections import deque
from os.path import join
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from fvt_tpu_torch import constants
from fvt_tpu_torch.data import windowing as W
from fvt_tpu_torch.data.transforms import (CROP_SIZE, SCALE_SIZE,
                                           center_crop_offset)
from fvt_tpu_torch.serve import lfan_serving_forward
from fvt_tpu_torch.train import metrics as M
from fvt_tpu_torch.train import optim
from fvt_tpu_torch.train.steps import TrainStep
from fvt_tpu_torch.utils import rng
from fvt_tpu_torch.utils.logger import log


class Trainer:
    """Trains and evaluates ``model`` under ``config``, a dict with the
    keys of ``fvt_tpu/config/defaults.py`` (training reads ``seed``,
    ``num_epochs``, ``min_num_epochs``, ``nan_guard`` and the ``opt__*``
    family; ``inference`` the eval keys, ``dataset_name``, ``outd`` and
    ``use_other_class``).  Runs on the card unless ``device='cpu'`` is
    passed."""

    def __init__(self, model: nn.Module, config: Dict[str, Any],
                 device=None, *, tcn_fused: bool = True,
                 reference: bool = False):
        self.config = config
        self.model_name = config.get('model_name', constants.LFAN)
        self.reference = reference
        self.hp = optim.standardize_opt_params(config)
        self.train_step = TrainStep(
            model, self.hp, device,
            task=config.get('task', constants.CLASSIFICATION),
            tcn_fused=tcn_fused, reference=reference)
        self.model = self.train_step.model
        self.device = self.train_step.device
        self.scheduler = optim.build_scheduler(
            self.hp, config['num_epochs'], config['min_num_epochs'])
        self.step_losses: list = []  # of the last epoch, one a step
        self.last_inference_timing: Optional[dict] = None

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        return self.train_step.optimizer

    def step_generator(self, epoch: int, step: int) -> torch.Generator:
        """A generator on the trainer's device for the stream
        (seed, 'epoch<e>', step): a step repeats bit for bit from the same
        state, whatever ran before it."""
        return rng.generator(self.config['seed'], f'epoch{epoch}', step,
                             self.device)

    def train_one_epoch(self, batches: Iterable[Dict[str, np.ndarray]],
                        epoch: int) -> float:
        """One pass over ``batches`` of numpy windows ``{modality:
        (B, T, D) float32, '*continuous_label': (B, T) int}``; then the
        scheduler's lr for the next epoch.  Returns the mean loss.  The
        losses stay on the device until the epoch ends."""
        losses = [self.train_step(batch, self.step_generator(epoch, i))
                  for i, batch in enumerate(batches)]
        self.step_losses = losses = [float(l) for l in losses]
        if self.config.get('nan_guard', False):
            for i, l in enumerate(losses):
                if not math.isfinite(l):
                    raise FloatingPointError(
                        f'non-finite loss {l} at epoch {epoch} step {i} '
                        f'(lr={optim.get_lr(self.optimizer):.3e})')
        if self.scheduler is not None:
            optim.set_lr(self.optimizer, self.scheduler.lr(epoch + 1))
        return sum(losses) / max(len(losses), 1)

    # ------------------------------------------------------------ inference
    def forward(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, T, C) logits of the eval forward on device tensors (uint8
        video, float32 or bfloat16 features)."""
        x = {k: v.float() if v.dtype == torch.bfloat16 else v
             for k, v in inputs.items()}
        return lfan_serving_forward(self.model, x, reference=self.reference)

    def inference(self, loader) -> tuple:
        """The eval pass over ``loader`` (an ``EvalLoader``): returns
        (perf, per-video ``{'labels', 'logits'}`` in work-list order) and,
        for the challenge dataset, writes
        ``<outd>/pred-C-EXPR-DB-CHALLENGE/prediction.pkl``.

        Videos up to the window are batched by bucket (up to
        ``eval_video_batch`` a forward); a longer video is windowed
        (window, hop) and stitched: with ``eval_device_windows`` it is
        uploaded once and its windows gathered on the device, otherwise
        the windows of all long videos are pooled on the host; either way
        ``eval_window_batch`` windows go through one forward.  Windows are
        independent at eval, so the chunking changes no output.
        ``last_inference_timing`` holds the pass's wall time by phase:
        loader_s (waiting on the loader), wingather_s (window index
        matrices and host gathers), dispatch_s (uploads and forwards as
        queued), sync_s (waiting for the logits on the host), stitch_s,
        and h2d_bytes."""
        cfg = self.config
        tm = {'loader_s': 0.0, 'wingather_s': 0.0, 'dispatch_s': 0.0,
              'sync_s': 0.0, 'stitch_s': 0.0, 'h2d_bytes': 0}
        self.last_inference_timing = tm
        _pc = time.perf_counter
        device = self.device
        per_video: Dict[str, dict] = {}
        win_threshold = (cfg['window_length']
                         if self.model_name == constants.LFAN else None)
        batch_videos = cfg.get('eval_video_batch', 8)
        if self.model_name in (constants.JMT, constants.MT):
            batch_videos = 1  # their final attention spans the batch
        window, hop = cfg['window_length'], cfg['hop_length']
        wb = int(cfg.get('eval_window_batch', 8) or 8)
        cast_feats = cfg.get('h2d_bf16_features', False)
        precrop = cfg.get('h2d_precrop_video', True)
        device_windows = cfg.get('eval_device_windows', True)

        # logits come to the host two forwards behind the queue
        pending: deque = deque()
        wstate: Dict[str, dict] = {}  # pooled host windows, by trial
        wqueue: list = []  # (trial, window row)

        def upload(arr: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if cast_feats and t.dtype == torch.float32:
                # rounded to bfloat16 (nearest even) on the host, widened
                # to float32 on the device by forward()
                t = t.to(torch.bfloat16)
            tm['h2d_bytes'] += t.numel() * t.element_size()
            return t.to(device, non_blocking=True)

        def maybe_precrop(batch):
            v = batch.get(constants.VIDEO)
            if (precrop and v is not None and v.dtype == np.uint8
                    and v.shape[-3] == SCALE_SIZE
                    and v.shape[-2] == SCALE_SIZE):
                off = center_crop_offset(SCALE_SIZE, CROP_SIZE)
                batch[constants.VIDEO] = np.ascontiguousarray(
                    v[..., off:off + CROP_SIZE, off:off + CROP_SIZE, :])
            return batch

        def dispatch_video_windows(batch, labels, trial, true_len):
            """The video uploaded once; its windows gathered on the
            device and run ``wb`` at a time."""
            t0 = _pc()
            mat = W.window_index_matrix(true_len, window, hop)
            tm['wingather_s'] += _pc() - t0
            t0 = _pc()
            arrays = {k: upload(v[0, :true_len]) for k, v in batch.items()}
            idx = torch.from_numpy(mat.astype(np.int64)).to(device)
            outs = [self.forward({k: v[idx[s:s + wb]]
                                  for k, v in arrays.items()})
                    for s in range(0, len(mat), wb)]
            pending.append(('vwin', outs, trial, mat, true_len,
                            np.asarray(labels[0, :true_len]).flatten()))
            tm['dispatch_s'] += _pc() - t0

        def enqueue_windowed(batch, labels, trial, true_len):
            t0 = _pc()
            mat = W.window_index_matrix(true_len, window, hop)
            n_win = mat.shape[0]
            arrs = {k: v[0][mat.reshape(-1)].reshape(
                (n_win, window) + v.shape[2:]) for k, v in batch.items()}
            tm['wingather_s'] += _pc() - t0
            wstate[trial] = dict(
                mat=mat, n_win=n_win, true_len=true_len,
                labels=np.asarray(labels[0, :true_len]).flatten(),
                arrs=arrs, outs=None, done=np.zeros(n_win, bool))
            wqueue.extend((trial, r) for r in range(n_win))

        def dispatch_window_batches(flush=False):
            while len(wqueue) >= wb or (flush and wqueue):
                t0 = _pc()
                rows = wqueue[:wb]
                del wqueue[:wb]
                inputs = {k: upload(np.stack(
                    [wstate[t]['arrs'][k][r] for (t, r) in rows]))
                    for k in wstate[rows[0][0]]['arrs']}
                pending.append(('win', self.forward(inputs), rows))
                tm['dispatch_s'] += _pc() - t0

        def finish_windowed(trial):
            t0 = _pc()
            st = wstate.pop(trial)
            per_video[trial] = {
                'labels': st['labels'],
                'logits': W.stitch_windows_np(st['outs'], st['mat'],
                                              st['true_len'])}
            tm['stitch_s'] += _pc() - t0

        def collect(entry):
            if entry[0] == 'vwin':
                _, outs, trial, mat, true_len, labels_v = entry
                t0 = _pc()
                out = torch.cat(outs).cpu().numpy()
                tm['sync_s'] += _pc() - t0
                t0 = _pc()
                per_video[trial] = {
                    'labels': labels_v,
                    'logits': W.stitch_windows_np(out, mat, true_len)}
                tm['stitch_s'] += _pc() - t0
                return
            if entry[0] == 'win':
                _, out, rows = entry
                t0 = _pc()
                out = out.cpu().numpy()
                tm['sync_s'] += _pc() - t0
                for i, (trial, r) in enumerate(rows):
                    st = wstate[trial]
                    if st['outs'] is None:
                        st['outs'] = np.empty(
                            (st['n_win'], window, out.shape[-1]),
                            np.float32)
                    st['outs'][r] = out[i]
                    st['done'][r] = True
                for trial in [t for t in wstate
                              if wstate[t]['done'].all()]:
                    finish_windowed(trial)
                return
            _, out, labels, trials, true_lens = entry
            t0 = _pc()
            out = out.cpu().numpy()
            tm['sync_s'] += _pc() - t0
            for j, trial in enumerate(trials):
                assert trial not in per_video, trial
                per_video[trial] = {
                    'labels': np.asarray(
                        labels[j, :true_lens[j]]).flatten(),
                    'logits': np.asarray(out[j][:true_lens[j]],
                                         dtype=np.float32),
                }

        # with precrop on, the loader emits 40^2 frames (the crop rides
        # the native resize); maybe_precrop crops any 48^2 batch left
        batch_iter = loader.batches(batch_videos,
                                    windowed_threshold=win_threshold,
                                    center_crop=(CROP_SIZE if precrop
                                                 else None))
        while True:
            t0 = _pc()
            nxt = next(batch_iter, None)
            tm['loader_s'] += _pc() - t0
            if nxt is None:
                break
            batch, trials, true_lens, bucket = nxt
            labels = batch.pop(constants.EXPR)  # (B, bucket)
            t0 = _pc()
            batch = maybe_precrop(batch)
            tm['dispatch_s'] += _pc() - t0

            windowed = (win_threshold is not None and len(trials) == 1
                        and true_lens[0] > win_threshold)
            if windowed and device_windows:
                dispatch_video_windows(batch, labels, trials[0],
                                       true_lens[0])
            elif windowed:
                enqueue_windowed(batch, labels, trials[0], true_lens[0])
                dispatch_window_batches()
            else:
                t0 = _pc()
                out = self.forward({k: upload(v) for k, v in batch.items()})
                pending.append(('bucket', out, labels, trials, true_lens))
                tm['dispatch_s'] += _pc() - t0
            while len(pending) > 2:
                collect(pending.popleft())

        dispatch_window_batches(flush=True)
        while pending:
            collect(pending.popleft())
        assert not wstate and not wqueue, (list(wstate), len(wqueue))

        # the work list's order; coverage asserted first
        want = {item[1] for item in loader.work_list}
        got = set(per_video)
        assert got == want, (
            f"inference coverage gap: missing={sorted(want - got)[:5]} "
            f"extra={sorted(got - want)[:5]}")
        per_video = {item[1]: per_video[item[1]]
                     for item in loader.work_list}

        perf = M.compute_perf(per_video, cfg['dataset_name'],
                              cfg['use_other_class'])

        if cfg['dataset_name'] == constants.C_EXPR_DB_CHALLENGE:
            out_inf = join(cfg['outd'],
                           f'pred-{constants.C_EXPR_DB_CHALLENGE}')
            os.makedirs(out_inf, exist_ok=True)
            with open(join(out_inf, 'prediction.pkl'), 'wb') as f:
                pkl.dump(per_video, f, protocol=pkl.HIGHEST_PROTOCOL)
            log(f"Dumped {constants.C_EXPR_DB_CHALLENGE} predictions at "
                f"{join(out_inf, 'prediction.pkl')}")

        return perf, per_video
