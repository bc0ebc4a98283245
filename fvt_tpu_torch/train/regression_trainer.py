"""The legacy valence/arousal regression fit loop of the port
(``fvt_tpu/train/regression_trainer.py``, the upstream
``GenericVideoTrainer.fit`` / ``loop``), on the port's ``TrainStep``
(``task=REGRESSION``: tanh head, CCC loss), its eval forward, its
optimizers and schedules, ``compute_regression_perf`` and
``regression_viz``.  Its semantics, each pinned by a test in lockstep
with ``fvt_tpu`` (``tests/test_torch_regression_trainer.py``):

  * epoch loss = the sum of the batches' mean losses over the number of
    sequences (not batches), an upstream quirk kept as it is;
  * the per-frame outputs and labels of overlapping windows are averaged
    per trial; the train records come from the same train-mode forward
    as the loss (``TrainStep(with_outputs=True)``);
  * the best model is selected by validation CCC (the concatenated
    'overall' partition), snapshotted and written as
    ``model_state_dict.msgpack`` in ``fvt_tpu``'s format;
  * early stopping only after ``min_num_epochs``: the countdown resets on
    an improvement and decrements otherwise; at 0 the run is marked
    finished and the next epoch breaks (the stopping epoch completes,
    its scheduler step included);
  * the scheduler is stepped per epoch on the validation loss;
  * at a milestone epoch (or when the lr falls under its floor) the best
    weights are reloaded and an optional :class:`ParamControl` releases
    the next staged group: the optimizer is built anew over the released
    parameters (fresh state, as upstream rebuilds it), and the run halts
    when the stack is exhausted;
  * ``load_best_at_each_epoch`` restores the running best after every
    epoch; ``fit`` always ends on the best weights;
  * frames that no window covers raise.

Batch protocol (the upstream dataloader's tuple): loaders yield ``(X,
trials, lengths, indices)``, where X holds one window of each modality
(B, w, ...) and one ``*continuous_label`` stream (B, w), ``trials`` names
each row's trial, ``lengths`` is the trial's length and ``indices`` (B, w)
maps the window's frames into the trial.

Checkpoints (``resume``) are the port's own, as ``train/checkpoint.py``'s:
``checkpoint.pt`` (``torch.save`` of the model's state, the optimizer's
state and the step count; ``torch.load(weights_only=True)`` reads it)
and the pickle sidecar ``checkpoint.pkl`` (the epoch, the countdown, the
best snapshot as numpy arrays, the scheduler's and the ParamControl's
state).  A run resumes in the package that started it.  The dropout of a
step draws from the stream (seed, 'epoch<e>', batch index), so a resumed
run repeats the uninterrupted one bit for bit.
"""
from __future__ import annotations

import os
import pickle
from os.path import join
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from fvt_tpu_torch import constants
from fvt_tpu_torch.models.checkpoint import save_best_model
from fvt_tpu_torch.serve import serving_forward
from fvt_tpu_torch.train import optim
from fvt_tpu_torch.train import regression_viz as RV
from fvt_tpu_torch.train.losses import ccc_loss
from fvt_tpu_torch.train.metrics import compute_regression_perf
from fvt_tpu_torch.train.param_control import freeze
from fvt_tpu_torch.train.steps import (FROZEN_PREFIX, TrainStep, label_key,
                                       to_device)
from fvt_tpu_torch.train.trainer import note_ignored_lr
from fvt_tpu_torch.utils import rng
from fvt_tpu_torch.utils.logger import log


class RegressionTrainer:
    """See the module docstring.  ``args`` (a namespace) needs the
    ``opt__*`` hyperparameters, ``num_epochs``, ``min_num_epochs``,
    ``early_stopping``, ``seed`` and ``outd``, and optionally
    ``milestone``, ``load_best_at_each_epoch``, ``save_plot`` and
    ``emotion``.  ``model`` is a port model built with
    ``task=REGRESSION``; it runs on the card unless ``device='cpu'``."""

    CKPT_NAME = 'checkpoint.pkl'
    CKPT_STATE = 'checkpoint.pt'

    def __init__(self, model: nn.Module, args, param_control=None,
                 device=None):
        self.args = args
        self.hp = optim.standardize_opt_params(vars(args))
        self.scheduler = optim.build_scheduler(
            self.hp, args.num_epochs, args.min_num_epochs)
        note_ignored_lr(self.hp, self.scheduler)
        self.train_step = TrainStep(model, self.hp, device,
                                    task=constants.REGRESSION,
                                    with_outputs=True)
        self.model = self.train_step.model
        self.device = self.train_step.device
        self.param_control = param_control

        emo = getattr(args, 'emotion', None)
        # '???' is the upstream configs' placeholder of the
        # classification datasets; VA runs name a dimension
        self.emotion = emo if emo and emo != '???' else 'valence'
        self.initialized = False
        self.start_epoch = 0
        self.fit_finished = False
        self.early_stopping_counter = int(getattr(args, 'early_stopping', 0))
        self.best = {'params': None, 'batch_stats': None,
                     'loss': 1e10, 'ccc': -1e10, 'epoch': 0}

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        return self.train_step.optimizer

    # ------------------------------------------------------------- state
    def init_state(self, sample_batch: Dict[str, np.ndarray]) -> None:
        """Starts the optimizer's state (and, with a ParamControl, freezes
        the optimizer to its base patterns: the staged groups stay locked
        until a release).  The model holds its weights from construction;
        ``sample_batch`` (one batch of the loaders) is checked to carry
        one label stream, as ``fvt_tpu`` inits its state from it."""
        label_key(sample_batch)
        if self.param_control is not None:
            self._rewrap_optimizer()
        else:
            self.train_step.optimizer = optim.build_optimizer(
                self.hp, self.train_step.trainable.values())
        self.train_step.step = 0
        self.initialized = True

    def _rewrap_optimizer(self) -> None:
        """The optimizer built anew over the parameters the ParamControl's
        current patterns release (fresh state, as upstream rebuilds its
        optimizer at each release)."""
        self.train_step.optimizer = freeze(
            self.hp, self.train_step.trainable,
            self.param_control.current_patterns())

    def _snapshot_best(self, val_loss: float, ccc: float,
                       epoch: int) -> None:
        """Host copies of the trainable parameters and of every buffer
        (the frozen backbones never change)."""
        params = dict(self.model.named_parameters())
        frozen = {k for k in params if k.startswith(FROZEN_PREFIX)}
        state = {k: v.detach().to('cpu', copy=True)
                 for k, v in self.model.state_dict().items()
                 if k not in frozen}
        self.best = {
            'params': {k: v for k, v in state.items() if k in params},
            'batch_stats': {k: v for k, v in state.items()
                            if k not in params},
            'loss': float(val_loss), 'ccc': float(ccc), 'epoch': epoch}

    def _restore_best(self) -> None:
        if self.best['params'] is None:
            return
        live = self.model.state_dict()
        with torch.no_grad():
            for part in ('params', 'batch_stats'):
                for k, v in self.best[part].items():
                    live[k].copy_(v)

    # -------------------------------------------------------- checkpoint
    def save_checkpoint(self) -> None:
        """The resume state: the model, the optimizer's state and the step
        count in ``checkpoint.pt``, the rest in ``checkpoint.pkl``, each
        written under a temporary name and moved into place, the sidecar
        last."""
        outd = self.args.outd
        state = {'model': self.model.state_dict(),
                 'optimizer': self.optimizer.state_dict(),
                 'step': torch.tensor(self.train_step.step)}
        tmp = join(outd, self.CKPT_STATE + '.tmp')
        torch.save(state, tmp)
        os.replace(tmp, join(outd, self.CKPT_STATE))
        pc = self.param_control
        best = dict(self.best)
        for part in ('params', 'batch_stats'):
            if best[part] is not None:
                best[part] = {k: np.asarray(v) for k, v in
                              best[part].items()}
        blob = {'start_epoch': self.start_epoch,
                'fit_finished': self.fit_finished,
                'early_stopping_counter': self.early_stopping_counter,
                'best': best,
                'scheduler': (self.scheduler.state_dict()
                              if self.scheduler is not None else None),
                'param_control': (None if pc is None else
                                  {'released': pc.released,
                                   'release_count': pc.release_count,
                                   'early_stop': pc.early_stop})}
        tmp = join(outd, self.CKPT_NAME + '.tmp')
        with open(tmp, 'wb') as f:
            pickle.dump(blob, f)
        os.replace(tmp, join(outd, self.CKPT_NAME))

    def load_checkpoint(self) -> None:
        """Resumes from ``outd``'s checkpoint; call after ``init_state``."""
        assert self.initialized, 'init_state first'
        outd = self.args.outd
        with open(join(outd, self.CKPT_NAME), 'rb') as f:
            blob = pickle.load(f)
        pc = blob.get('param_control')
        if self.param_control is not None and pc is not None:
            # the release stage first: it decides the optimizer's
            # parameters, whose state is read next
            self.param_control.released = int(pc['released'])
            self.param_control.release_count = int(pc['release_count'])
            self.param_control.early_stop = bool(pc['early_stop'])
            self._rewrap_optimizer()
        state = torch.load(join(outd, self.CKPT_STATE),
                           map_location=self.device, weights_only=True)
        self.model.load_state_dict(state['model'], strict=True)
        self.optimizer.load_state_dict(state['optimizer'])
        self.train_step.step = int(state['step'])
        self.start_epoch = int(blob['start_epoch'])
        self.fit_finished = bool(blob['fit_finished'])
        self.early_stopping_counter = int(blob['early_stopping_counter'])
        best = blob['best']
        for part in ('params', 'batch_stats'):
            if best[part] is not None:
                best[part] = {k: torch.from_numpy(v) for k, v in
                              best[part].items()}
        self.best = best
        if self.scheduler is not None and blob['scheduler'] is not None:
            self.scheduler.load_state_dict(blob['scheduler'])

    # -------------------------------------------------------------- loop
    @staticmethod
    def _accumulate(acc: Dict[str, dict], trials, lengths, indices,
                    **rows: np.ndarray) -> None:
        """Adds one batch of per-window rows (one named array per stream,
        e.g. sums=outputs, labsums=labels) into the per-trial per-frame
        sums, counting each frame's windows (upstream
        ContinuousOutputHandler; it stops at the trial's length)."""
        w = min(arr.shape[1] for arr in rows.values())
        for i, trial in enumerate(trials):
            a = acc.get(trial)
            if a is None:
                a = acc[trial] = {k: np.zeros(int(lengths[i]))
                                  for k in (*rows, 'counts')}
            k = min(int(lengths[i]), w)
            idx = np.asarray(indices[i][:k], np.int64)
            for key, arr in rows.items():
                np.add.at(a[key], idx, arr[i, :k])
            np.add.at(a['counts'], idx, 1.0)

    @staticmethod
    def _finalize(a: dict, key: str, trial: str) -> np.ndarray:
        """The per-frame average; a frame no window covers raises, as the
        upstream handler fails on its empty per-frame list (a made-up
        (0, 0) pair would distort the CCC that selects the best model)."""
        uncovered = int((a['counts'] == 0).sum())
        if uncovered:
            raise ValueError(
                f'trial {trial}: {uncovered} frames covered by no '
                f'window — the window/hop plan must tile each trial')
        return a[key] / a['counts']

    def eval_forward(self, inputs: Dict[str, np.ndarray]) -> torch.Tensor:
        """(B, T, 1) outputs of the eval forward on numpy inputs."""
        return serving_forward(self.model, to_device(inputs, self.device))

    def loop(self, loader: Iterable, epoch: Optional[int],
             train_mode: bool) -> tuple:
        """One pass: (epoch loss, perf, per-trial records {'labels',
        'preds'})."""
        assert self.initialized, 'init_state first'
        running_loss, n_seqs = 0.0, 0
        acc: Dict[str, dict] = {}  # trial -> sums/labsums/counts
        for i, (X, trials, lengths, indices) in enumerate(loader):
            n_seqs += len(trials)
            lkey = label_key(X)
            if train_mode:
                loss, out = self.train_step(X, rng.generator(
                    self.args.seed, f'epoch{epoch or 0}', i, self.device))
            else:
                out = self.eval_forward({k: v for k, v in X.items()
                                         if k != lkey})
                loss = ccc_loss(torch.as_tensor(X[lkey]).to(
                    self.device, out.dtype), out[..., 0])
            running_loss += float(loss)
            self._accumulate(
                acc, trials, lengths, indices,
                sums=out[..., 0].cpu().numpy().astype(np.float64),
                labsums=np.asarray(X[lkey], np.float64))
        per_video = {
            trial: {'labels': self._finalize(a, 'labsums', trial),
                    'preds': self._finalize(a, 'sums', trial)}
            for trial, a in acc.items()}
        # the batches' mean losses summed over the number of sequences
        epoch_loss = running_loss / max(n_seqs, 1)
        return epoch_loss, compute_regression_perf(per_video), per_video

    # --------------------------------------------------------------- fit
    def fit(self, train_loader_fn: Callable[[int], Iterable],
            valid_loader_fn: Callable[[], Iterable]) -> dict:
        """``train_loader_fn(epoch)`` yields a train pass,
        ``valid_loader_fn()`` a validation pass.  Returns the best
        snapshot."""
        outd = self.args.outd
        os.makedirs(outd, exist_ok=True)
        if self.start_epoch == 0:  # a resumed run appends to its rows
            RV.init_epoch_csv(outd)
        milestones = set(optim.parse_milestones(
            getattr(self.args, 'milestone', None)))

        for epoch in range(self.start_epoch, self.args.num_epochs):
            if self.fit_finished:
                log('regression fit: early stop')
                break
            lr_floor = (self.scheduler is not None
                        and self.scheduler.lr(epoch)
                        < getattr(self.hp, 'min_lr', 0.0))
            if epoch in milestones or lr_floor:
                # release the next staged group and restart from the
                # running best (the lr floor is upstream's second trigger)
                if self.param_control is not None:
                    optimizer = self.param_control.release(
                        self.hp, self.train_step.trainable)
                    if self.param_control.early_stop:
                        log('regression fit: param_control exhausted — '
                            'early stop')
                        break
                    self.train_step.optimizer = optimizer
                self._restore_best()
            if self.scheduler is not None:
                optim.set_lr(self.optimizer, self.scheduler.lr(epoch))

            tr_loss, tr_perf, tr_records = self.loop(
                train_loader_fn(epoch), epoch, train_mode=True)
            val_loss, val_perf, val_records = self.loop(
                valid_loader_fn(), epoch, train_mode=False)
            self._save_trialwise(tr_records, tr_perf, True, epoch)
            self._save_trialwise(val_records, val_perf, False, epoch)

            improvement = val_perf['ccc'] > self.best['ccc']
            if improvement:
                self._snapshot_best(val_loss, val_perf['ccc'], epoch)
                self._save_best(outd)

            lr = (self.scheduler.lr(epoch) if self.scheduler is not None
                  else self.args.opt__lr)
            RV.append_epoch_csv(outd, epoch, self.best['epoch'], lr,
                                tr_loss, val_loss, tr_perf, val_perf)
            if getattr(self.args, 'save_plot', False):
                RV.save_output_vs_label_plots(val_records, val_perf, outd,
                                              epoch, train_mode=False)
            log(f'regression epoch {epoch}: train {tr_loss:.4f} '
                f'valid {val_loss:.4f} ccc {val_perf["ccc"]:.4f} '
                f'best@{self.best["epoch"]}')

            # gated on the configured value, as upstream: the countdown
            # itself may reach 0
            if (int(getattr(self.args, 'early_stopping', 0))
                    and epoch > self.args.min_num_epochs):
                if improvement:
                    self.early_stopping_counter = int(
                        self.args.early_stopping)
                else:
                    self.early_stopping_counter -= 1
                if self.early_stopping_counter <= 0:
                    self.fit_finished = True

            if self.scheduler is not None:
                self.scheduler.step(epoch, metric=val_loss)
            if getattr(self.args, 'load_best_at_each_epoch', False):
                self._restore_best()
            # the checkpoint last, after the scheduler's step, as upstream
            self.start_epoch = epoch + 1
            self.save_checkpoint()

        self.fit_finished = True
        self.save_checkpoint()
        self._restore_best()
        return self.best

    def _save_best(self, outd: str) -> None:
        """``model_state_dict.msgpack``: the best snapshot (with the frozen
        backbones) in ``fvt_tpu``'s format, the bytes of flax's
        ``to_bytes`` over ``{'params', 'batch_stats'}``."""
        state = {k: v.detach() for k, v in self.model.state_dict().items()}
        state.update(self.best['params'])
        state.update(self.best['batch_stats'])
        save_best_model(state, join(outd, 'model_state_dict.msgpack'),
                        self.model.modality)

    def _save_trialwise(self, per_video: Dict[str, dict], perf: dict,
                        train_mode: bool, epoch: Optional[int]) -> str:
        """The trial-wise records pickle in the upstream layout:
        ``dict/<emotion>/{train|validate}/epoch_<e>.pkl`` per epoch and
        ``dict/<emotion>/test.pkl`` for the final pass, with the outputs,
        the continuous labels, and per-trial and 'overall' rmse/pcc/ccc."""
        base = join(self.args.outd, 'dict', self.emotion)
        if epoch is None:
            path = join(base, 'test.pkl')
        else:
            sub = 'train' if train_mode else 'validate'
            path = join(base, sub, f'epoch_{epoch}.pkl')
        os.makedirs(os.path.dirname(path), exist_ok=True)
        metrics = {t: compute_regression_perf({t: rec})
                   for t, rec in per_video.items()}
        metrics['overall'] = perf
        with open(path, 'wb') as f:
            pickle.dump({'output': {t: r['preds']
                                    for t, r in per_video.items()},
                         'continuous_label': {t: r['labels']
                                              for t, r in
                                              per_video.items()},
                         'metrics': metrics}, f)
        return path

    # ----------------------------------------------------------- predict
    def predict(self, loader_fn: Callable[[], Iterable], partition: str,
                emotion: str = 'valence') -> Dict[str, np.ndarray]:
        """A label-free pass: the averaged per-frame outputs of each trial,
        written as ``predict/<partition>/<emotion>/<trial>.txt`` (a header
        line naming the emotion, one value a frame)."""
        assert self.initialized, 'init_state first'
        acc: Dict[str, dict] = {}
        for X, trials, lengths, indices in loader_fn():
            out = self.eval_forward({k: v for k, v in X.items()
                                     if 'label' not in k})
            self._accumulate(
                acc, trials, lengths, indices,
                sums=out[..., 0].cpu().numpy().astype(np.float64))
        outd = join(self.args.outd, 'predict', partition, emotion)
        os.makedirs(outd, exist_ok=True)
        written = {}
        for trial, a in acc.items():
            preds = self._finalize(a, 'sums', trial)
            with open(join(outd, f'{trial}.txt'), 'w') as f:
                f.write(emotion + '\n')
                f.write('\n'.join(str(v) for v in preds) + '\n')
            written[trial] = preds
        return written

    # -------------------------------------------------------------- test
    def test(self, test_loader_fn: Callable[[], Iterable]) -> tuple:
        """The held-out pass on the best weights: its records, the CSV's
        test row, and the test plots with ``save_plot``."""
        self._restore_best()
        loss, perf, records = self.loop(test_loader_fn(), None,
                                        train_mode=False)
        self._save_trialwise(records, perf, False, None)
        RV.append_test_csv(self.args.outd, perf)
        if getattr(self.args, 'save_plot', False):
            RV.save_output_vs_label_plots(records, perf, self.args.outd,
                                          epoch=None)
        return loss, perf, records
