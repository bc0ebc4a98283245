"""The training and evaluation runtime of the port
(``fvt_tpu/train/trainer.py``): epochs of optimizer steps over window
batches with the per-epoch learning-rate schedule and the finite-loss
guard (``train_one_epoch``); ``inference``, the eval pass over a store's
videos that validation, test and challenge inference run
(``trainer.py:412-704``); and the run loop (``optimize``): validation
before the first epoch and after each, the best model of each selection
criterion, early stopping, checkpoints, the test pass of each best model
and the run directory's artifacts
(``test-<case>-perf.{txt,pkl}``, ``pred-per-frame-test-<case>-perf.pkl``,
``best-models/<case>/{model.msgpack,config.yml}``, ``config.yml``,
``passed.txt``), as ``fvt_tpu`` writes them.

``--profile_epochs N`` traces the epochs below N with ``torch.profiler``
(host and, on the card, device activity) into
``<outd>/profile/epoch<e>.pt.trace.json``, a Chrome trace, closed on
every exit from the epoch (``fvt_tpu`` writes a ``jax.profiler`` trace
there, ``trainer.py:186-195``).  ``--serve_quant int8_static`` calibrates
the int8 ArcFace on one batch (:meth:`Trainer.calibrate_quant`).

Data parallel (``fvt_tpu``'s ``--data_parallel`` branches,
``trainer.py:116-123, 196-304, 317-402``): given a ``world``
(``parallel/mesh.py``), the step is ``parallel/dp.py``'s, each rank builds
its row slice of every batch (``TrainLoader.epoch_local``), a batch the
world size does not divide runs replicated (counted and logged,
``--multihost_digest_check`` all-gathers its digest first), and the eval
pass spreads the window batches of a long LFAN video over the ranks and
all-gathers their logits (each padded to a multiple of the world size, as
``fvt_tpu`` pads to its device count); the rest of the eval pass, JMT's
and MT's whole, runs replicated on every rank.  Only rank 0 writes the
run's files.
"""
from __future__ import annotations

import contextlib
import datetime as dt
import math
import os
import pickle as pkl
import time
from collections import deque
from os.path import join
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from fvt_tpu_torch import constants
from fvt_tpu_torch.config.parse import save_config
from fvt_tpu_torch.data import windowing as W
from fvt_tpu_torch.data.transforms import (CROP_SIZE, SCALE_SIZE,
                                           center_crop_offset)
from fvt_tpu_torch.models.checkpoint import save_best_model
from fvt_tpu_torch.models.registry import split_modality
from fvt_tpu_torch.parallel import dp
from fvt_tpu_torch.serve import (calibrate_act_scales, serving_forward,
                                 valid_frames)
from fvt_tpu_torch.train import metrics as M
from fvt_tpu_torch.train import optim
from fvt_tpu_torch.train.steps import FROZEN_PREFIX, TrainStep
from fvt_tpu_torch.utils import bf16, rng
from fvt_tpu_torch.utils.logger import fmsg, log


def note_ignored_lr(hp, scheduler) -> None:
    """Logs the NOTE that ``opt__lr`` is ignored where it is
    (``fvt_tpu/train/trainer.py:99-113``): unless ``opt__honor_lr``, the
    optimizer trains at PyTorch's default lr, as upstream builds it, and
    only MYWARMUP carries ``opt__lr``."""
    lr = getattr(hp, 'lr', optim.TORCH_DEFAULT_LR)
    if (not getattr(hp, 'honor_lr', False)
            and not isinstance(scheduler, optim.MyWarmupSchedule)
            and abs(lr - optim.TORCH_DEFAULT_LR) > 1e-12):
        # keyed on the built scheduler: MYWARMUP carries opt__lr
        log(fmsg(
            f"NOTE: opt__lr={lr} is IGNORED — reproducing the upstream "
            f"optimizer wiring (its SGD/Adam are built without lr; "
            f"effective lr = {optim.TORCH_DEFAULT_LR}). Pass "
            f"--opt__honor_lr true to actually train at opt__lr."))


class EarlyStopper:
    """Early stopping with the upstream legacy semantics: once past
    ``min_epochs``, a countdown from ``budget`` that resets to ``budget``
    on a validation improvement and decrements otherwise; reaching 0
    stops.  ``budget`` <= 0 disables it."""

    def __init__(self, budget: int, min_epochs: int):
        self.budget = int(budget or 0)
        self.min_epochs = min_epochs
        self.counter = self.budget

    def should_stop(self, epoch: int, improved: bool) -> bool:
        if self.budget <= 0 or (epoch + 1) <= self.min_epochs:
            return False
        self.counter = self.budget if improved else self.counter - 1
        return self.counter <= 0


class Trainer:
    """Trains and evaluates ``model`` (the port's LFAN, CAN, JMT or MT;
    its family picks the eval pass's batching and mask) under ``config``,
    a dict with the
    keys of ``fvt_tpu/config/defaults.py`` (training reads ``seed``,
    ``num_epochs``, ``min_num_epochs``, ``nan_guard`` and the ``opt__*``
    family; ``inference`` the eval keys, ``dataset_name``, ``outd`` and
    ``use_other_class``; ``optimize`` also ``modality``,
    ``early_stopping`` and ``save_plot``, and writes ``tend`` into it).
    ``int_to_cl`` names the classes in the test reports.  Runs on the
    card unless ``device='cpu'`` is passed.  With ``world`` (a
    ``parallel.mesh.World``) it trains data-parallel on ``world.device``
    (module docstring)."""

    def __init__(self, model: nn.Module, config: Dict[str, Any],
                 device=None, *, tcn_fused: bool = True,
                 reference: bool = False,
                 int_to_cl: Optional[Dict[int, str]] = None, world=None):
        self.config = config
        self.int_to_cl = int_to_cl
        self.model_name = model.model_name  # the family's, not config's
        self.reference = reference
        self.world = world
        self.hp = optim.standardize_opt_params(config)
        kw = dict(task=config.get('task', constants.CLASSIFICATION),
                  tcn_fused=tcn_fused, reference=reference)
        if world is None:
            self.train_step = TrainStep(model, self.hp, device, **kw)
        else:
            self.train_step = dp.DPTrainStep(model, self.hp, world, **kw)
            log(fmsg(f'data-parallel over {world.size} ranks '
                     f'({world.backend}), this one rank {world.rank} on '
                     f'{world.device}'))
        self.model = self.train_step.model
        self.device = self.train_step.device
        self.scheduler = optim.build_scheduler(
            self.hp, config['num_epochs'], config['min_num_epochs'])
        note_ignored_lr(self.hp, self.scheduler)
        self.step_losses: list = []  # of the last epoch, one a step
        self.last_epoch_timing: Optional[dict] = None
        self.last_inference_timing: Optional[dict] = None
        # of the last optimize: the validation and test trackers, the
        # epoch losses, the early stopper
        self.valid_tracker: Optional[dict] = None
        self.test_tracker: Optional[dict] = None
        self.loss_tracker: list = []
        self.stopper: Optional[EarlyStopper] = None

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        return self.train_step.optimizer

    @property
    def writer(self) -> bool:
        """Whether this process writes the run's files: rank 0 only."""
        return self.world is None or self.world.writer

    def step_generator(self, epoch: int, step: int) -> torch.Generator:
        """A generator on the trainer's device for the stream
        (seed, 'epoch<e>', step): a step repeats bit for bit from the same
        state, whatever ran before it."""
        return rng.generator(self.config['seed'], f'epoch{epoch}', step,
                             self.device)

    def train_one_epoch(self, loader, epoch: int) -> float:
        """One pass over ``loader``: a ``TrainLoader``, whose
        ``epoch(epoch)`` gives the batches, or any iterable of numpy
        windows ``{modality: (B, T, D) float32, '*continuous_label': (B,
        T) int}``; then the scheduler's lr for the next epoch.  Returns the
        mean loss and logs it.  The losses stay on the device until the
        epoch ends.  ``last_epoch_timing`` holds the epoch's wall time by
        phase: loader_s (waiting for the next batch), step_s (the steps'
        uploads and queued kernels), sync_s (waiting for the losses).
        Below ``profile_epochs`` the epoch runs under ``torch.profiler``
        (module docstring)."""
        t0 = dt.datetime.now()
        _pc = time.perf_counter
        tm = {'loader_s': 0.0, 'step_s': 0.0, 'sync_s': 0.0}
        self.last_epoch_timing = tm
        world = self.world
        ragged = sharded = 0
        with self.profiled(epoch):
            if world is not None:
                # each rank builds its row slice of every batch; the plan
                # is the seed's, so every rank cuts the same batches
                batches = iter(loader.epoch_local(
                    epoch, divisor=world.size, process_index=world.rank,
                    process_count=world.size))
            else:
                batches = iter(loader.epoch(epoch) if hasattr(loader, 'epoch')
                               else loader)
            losses = []
            while True:
                t = _pc()
                batch = next(batches, None)
                tm['loader_s'] += _pc() - t
                if batch is None:
                    break
                t = _pc()
                gen = self.step_generator(epoch, len(losses))
                if world is None:
                    losses.append(self.train_step(batch, gen))
                else:
                    batch, rows = batch
                    if len(next(iter(batch.values()))) == rows \
                            and world.size > 1:
                        ragged += 1
                        if self.config.get('multihost_digest_check', False):
                            dp.assert_ranks_agree(batch, self.device)
                    else:
                        sharded += 1
                    losses.append(self.train_step(batch, gen, rows))
                tm['step_s'] += _pc() - t
            t = _pc()
            self.step_losses = losses = [float(l) for l in losses]
            tm['sync_s'] = _pc() - t
            if self.config.get('nan_guard', False):
                for i, l in enumerate(losses):
                    if not math.isfinite(l):
                        raise FloatingPointError(
                            f'non-finite loss {l} at epoch {epoch} step '
                            f'{i} (lr={optim.get_lr(self.optimizer):.3e})')
        if self.scheduler is not None:
            optim.set_lr(self.optimizer, self.scheduler.lr(epoch + 1))
        if ragged:
            # every rank builds and computes such a batch whole
            log(fmsg(f'data-parallel: {ragged}/{ragged + sharded} batches '
                     f'ran replicated (size not divisible by '
                     f'{world.size} ranks); each replicates its IO+build '
                     f'on every rank'))
        epoch_loss = sum(losses) / max(len(losses), 1)
        log(fmsg(f"Train epoch ({epoch}/{self.config['num_epochs']}) "
                 f"loss: {epoch_loss:.6f} "
                 f"runtime: {dt.datetime.now() - t0}"))
        return epoch_loss

    @contextlib.contextmanager
    def profiled(self, epoch: int):
        """Runs its body under ``torch.profiler`` if ``epoch`` is below
        ``profile_epochs`` and writes the trace on every exit, the
        finite-loss guard's raise included: a trace left open loses the
        epoch one wants to see."""
        if epoch >= int(self.config.get('profile_epochs', 0) or 0):
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        path = join(self.config['outd'], 'profile',
                    f'epoch{epoch}.pt.trace.json')
        log(f"torch.profiler tracing epoch {epoch} -> {path}")
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        try:
            yield
        finally:
            prof.stop()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            prof.export_chrome_trace(path)

    def calibrate_quant(self, sample_batch: Dict[str, np.ndarray]) -> dict:
        """``--serve_quant int8_static`` (``fvt_tpu``'s
        ``Trainer.calibrate_quant``, ``trainer.py:153-179``): the running
        ``max|x|`` of each int8 conv over one representative batch, through
        the eval forward; the ArcFace then serves with those scales.  They
        live on its convs, so both eval paths (the bucketed forward and the
        device-windowed stitch) read them with nothing to rebuild.  Returns
        the ``act_scales`` tree (``serve.calibrate_act_scales``)."""
        scales = calibrate_act_scales(self.model, sample_batch, self.device,
                                      reference=self.reference)
        n = len(self.model.spatial.visual.int8_convs())
        log(fmsg(f'int8_static: calibrated {n} activation scales'))
        return scales

    # ------------------------------------------------------------ inference
    def forward(self, inputs: Dict[str, torch.Tensor],
                lengths: Optional[Sequence[int]] = None) -> torch.Tensor:
        """(B, T, C) logits of the eval forward on device tensors (uint8
        video, float32 or bfloat16 features).  A JMT or MT attends over
        the first ``lengths[b]`` frames of row b (all T by default), as
        ``fvt_tpu``'s ``make_eval_step(needs_time_mask=True)``."""
        x = inputs
        mask = None
        if self.model.needs_time_mask:
            b, t = next(iter(x.values())).shape[:2]
            mask = valid_frames([t] * b if lengths is None else lengths, t,
                                self.device)
        return serving_forward(self.model, x, time_mask=mask,
                               reference=self.reference)

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
        independent at eval, so the chunking changes no output, except
        under dynamic int8 (``model.whole_calls``), whose scale spans the
        call: a device-windowed video then goes through one forward of all
        its windows, as ``fvt_tpu``'s one jit over them.
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
        if self.model.needs_time_mask:
            batch_videos = 1  # their final attention spans the batch
        window, hop = cfg['window_length'], cfg['hop_length']
        wb = int(cfg.get('eval_window_batch', 8) or 8)
        # data parallel: each window batch spread over the ranks (never a
        # dynamic-int8 one, whose scales span the call)
        world = self.world
        spread = (world is not None and world.size > 1
                  and not self.model.whole_calls)
        if spread:
            wb = -(-max(wb, world.size) // world.size) * world.size
        cast_feats = cfg.get('h2d_bf16_features', False)
        precrop = cfg.get('h2d_precrop_video', True)
        device_windows = cfg.get('eval_device_windows', True)

        # logits come to the host two forwards behind the queue
        pending: deque = deque()
        wstate: Dict[str, dict] = {}  # pooled host windows, by trial
        wqueue: list = []  # (trial, window row)

        def upload(arr: np.ndarray) -> torch.Tensor:
            if cast_feats and arr.dtype == np.float32:
                # rounded to bfloat16 on the host as ml_dtypes rounds,
                # widened to float32 on the device by serving_forward
                bits = bf16.bf16_bits(arr)
                tm['h2d_bytes'] += bits.nbytes
                return bf16.to_device(bits, device)
            t = torch.from_numpy(np.ascontiguousarray(arr))
            tm['h2d_bytes'] += t.numel() * t.element_size()
            return t.to(device, non_blocking=True)

        def spread_forward(inputs_of, n):
            """The logits of ``n`` windows, ``inputs_of(lo, hi)`` giving
            the inputs of windows [lo, hi) (past n: the last one again):
            this rank's share of them forwarded, every rank's gathered."""
            if not spread:
                return self.forward(inputs_of(0, n))
            return dp.gather_eval(self.forward(inputs_of(
                *dp.shard_rows(n, world))), n)

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
            step = len(mat) if self.model.whole_calls else wb
            outs = []
            for s in range(0, len(mat), step):
                chunk = idx[s:s + step]
                outs.append(spread_forward(
                    lambda lo, hi, c=chunk: {
                        k: v[dp.pad_rows(c, hi)[lo:hi]]
                        for k, v in arrays.items()}, len(chunk)))
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

                def inputs_of(lo, hi, rows=rows):
                    take = [rows[min(i, len(rows) - 1)]
                            for i in range(lo, hi)]
                    return {k: upload(np.stack(
                        [wstate[t]['arrs'][k][r] for (t, r) in take]))
                        for k in wstate[rows[0][0]]['arrs']}
                pending.append(('win', spread_forward(inputs_of, len(rows)),
                                rows))
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
                out = self.forward({k: upload(v) for k, v in batch.items()},
                                   true_lens)
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

        if cfg['dataset_name'] == constants.C_EXPR_DB_CHALLENGE \
                and self.writer:
            out_inf = join(cfg['outd'],
                           f'pred-{constants.C_EXPR_DB_CHALLENGE}')
            os.makedirs(out_inf, exist_ok=True)
            with open(join(out_inf, 'prediction.pkl'), 'wb') as f:
                pkl.dump(per_video, f, protocol=pkl.HIGHEST_PROTOCOL)
            log(f"Dumped {constants.C_EXPR_DB_CHALLENGE} predictions at "
                f"{join(out_inf, 'prediction.pkl')}")

        return perf, per_video

    # ------------------------------------------------------------- run loop
    def best_copy(self) -> Dict[str, torch.Tensor]:
        """A host copy of the trainable parameters and of every buffer
        (the BatchNorm statistics, the frozen backbone's too, which a
        train-mode step moves): the frozen parameters never change and
        are not copied.  Cloned, since ``state_dict`` hands out the live
        tensors that the optimizer updates in place."""
        frozen = {k for k, _ in self.model.named_parameters()
                  if k.startswith(FROZEN_PREFIX)}
        return {k: v.detach().to('cpu', copy=True)
                for k, v in self.model.state_dict().items()
                if k not in frozen}

    def load_copy(self, copy: Dict[str, torch.Tensor]) -> None:
        """Writes a :meth:`best_copy` back into the live model."""
        live = self.model.state_dict()
        with torch.no_grad():
            for k, v in copy.items():
                live[k].copy_(v)

    def optimize(self, train_loader, valid_loader, test_loader,
                 checkpointer=None) -> tuple:
        """The training run (``fvt_tpu``'s ``Trainer.optimize``): returns
        the validation and test trackers, by selection criterion."""
        cfg = self.config
        log(fmsg(f"Starting training on {self.device}"))
        t_start = time.time()

        start_epoch = 0
        valid_tracker = restored = None
        if checkpointer is not None and checkpointer.allow_restore:
            restored = checkpointer.restore(self, scheduler=self.scheduler)
        if restored is not None:
            last_epoch, valid_tracker, best, loss_tracker = restored
            start_epoch = last_epoch + 1
        if self.scheduler is not None:
            # epoch 0 trains at the schedule's lr(0), as a torch scheduler
            # sets it at construction; a resumed run at lr(start)
            optim.set_lr(self.optimizer, self.scheduler.lr(start_epoch))
        if valid_tracker is None:
            current_perf, _ = self.inference(valid_loader)
            valid_tracker = M.build_trackers(cfg['dataset_name'],
                                             cfg['use_other_class'])
            best, loss_tracker = {}, []
            for item, tracker in valid_tracker.items():
                tracker.append(current_perf)
                best[item] = self.best_copy()
                log(f"{constants.VALIDSET}: {tracker.current_status_str}")
                log(f"{constants.VALIDSET}: {tracker.best_status_str}")
        test_tracker = M.build_trackers(cfg['dataset_name'],
                                        cfg['use_other_class'])

        if isinstance(self.scheduler, optim.MyWarmupSchedule) and \
                self.scheduler.mode == 'min' and \
                cfg.get('task') == constants.CLASSIFICATION:
            log("WARNING: MYWARMUP plateau metric is the validation master "
                "(W-F1: higher is better) but opt__mode is MIN — set "
                "--opt__mode max to count plateaus correctly")

        self.stopper = stopper = EarlyStopper(cfg.get('early_stopping', 0),
                                              cfg['min_num_epochs'])
        if restored is not None and \
                checkpointer.restored_stopper_counter is not None:
            stopper.counter = int(checkpointer.restored_stopper_counter)

        for epoch in range(start_epoch, cfg['num_epochs']):
            epoch_loss = self.train_one_epoch(train_loader, epoch)
            loss_tracker.append(epoch_loss)

            current_perf, _ = self.inference(valid_loader)
            improved = False
            for item, tracker in valid_tracker.items():
                # a tie refreshes the best copy (`>=`); the early-stop
                # countdown resets only on a strict improvement
                prev_best = tracker.best_value
                tracker.append(current_perf)
                if tracker.is_last_best:
                    best[item] = self.best_copy()
                    if prev_best is None or tracker.best_value > prev_best:
                        improved = True
                log(f"{constants.VALIDSET}: {tracker.current_status_str}")
                log(f"{constants.VALIDSET}: {tracker.best_status_str}")

            # MYWARMUP's plateau decay reads the validation master metric
            if isinstance(self.scheduler, optim.MyWarmupSchedule):
                try:
                    metric = next(iter(valid_tracker.values())) \
                        ._master_value(current_perf)
                except (KeyError, StopIteration):
                    metric = epoch_loss
                self.scheduler.step(epoch, metric)
                optim.set_lr(self.optimizer, self.scheduler.lr(epoch + 1))

            # the countdown moves before the checkpoint, which saves the
            # post-epoch counter a resumed run continues from
            stop = stopper.should_stop(epoch, improved)
            if checkpointer is not None and checkpointer.should_save(epoch) \
                    and self.writer:
                checkpointer.save(epoch, self, valid_tracker, best,
                                  loss_tracker, scheduler=self.scheduler,
                                  stopper_counter=stopper.counter)
            if stop:
                log(fmsg(f"Early stopping at epoch {epoch}: no validation "
                         f"improvement in {stopper.budget} epochs"))
                break

        # each best model: the test pass, its artifacts and the model
        log(fmsg(f"{constants.TESTSET} performance:"))
        live = self.best_copy()
        outd = cfg['outd']
        modality = split_modality(cfg['modality'])
        for item, copy in best.items():
            self.load_copy(copy)
            current_perf, per_video = self.inference(test_loader)
            test_tracker[item].append(current_perf)
            log(f"{constants.TESTSET}: "
                f"{test_tracker[item].current_status_str}")
            if not self.writer:
                continue
            with open(join(outd, f"{constants.TESTSET}-{item}-perf.txt"),
                      'w') as f:
                f.write(test_tracker[item].report(current_perf,
                                                  self.int_to_cl))
            for name, obj in ((f"{constants.TESTSET}-{item}-perf.pkl",
                               current_perf),
                              (f"pred-per-frame-{constants.TESTSET}-{item}"
                               f"-perf.pkl", per_video)):
                with open(join(outd, name), 'wb') as f:
                    pkl.dump(obj, f, protocol=pkl.HIGHEST_PROTOCOL)
            best_dir = join(outd, 'best-models', f"{item}")
            os.makedirs(best_dir, exist_ok=True)
            save_best_model(self.model, join(best_dir, 'model.msgpack'),
                            modality)
            save_config(cfg, join(best_dir, 'config.yml'))
        self.load_copy(live)

        if cfg.get('save_plot', False) and self.writer:
            for item, tracker in valid_tracker.items():
                tracker.plot(join(outd, f'tracker-{item}.png'), loss_tracker)

        self.valid_tracker, self.test_tracker = valid_tracker, test_tracker
        self.loss_tracker = loss_tracker
        cfg['tend'] = dt.datetime.now()
        if self.writer:
            save_config(cfg, join(outd, 'config.yml'))
        self.bye(t_start)
        return valid_tracker, test_tracker

    def bye(self, t_start: float) -> None:
        log(fmsg(f"Total time: {time.time() - t_start:.1f}s"))
        if self.writer:
            with open(join(self.config['outd'], 'passed.txt'), 'w') as f:
                f.write('Passed.')
        log(fmsg('bye.'))
