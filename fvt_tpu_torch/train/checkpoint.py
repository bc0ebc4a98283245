"""Periodic checkpoint and resume of a training run (the counterpart of
``fvt_tpu/train/checkpoint.py``).

Every ``checkpoint_every`` epochs the run's state goes to
``<outd>/checkpoints`` in two files an epoch:

* ``state_<epoch>.pt``, one ``torch.save`` of the tensors: the model's
  parameters and buffers, the optimizer's ``state_dict`` (SGD's momentum,
  Adam's moments) and the step count.  ``torch.load(weights_only=True)``
  reads it.
* ``meta_<epoch>.pkl``, a pickle sidecar of the rest: the epoch, the loss
  history, each criterion's PerfTracker, the best-model copies (numpy
  arrays), the scheduler's state (MYWARMUP's plateau lr) and the early
  stopper's countdown.  ``weights_only`` loading refuses such objects,
  which is why they are apart.

Both are written to a temporary name and moved into place, the sidecar
last; a step whose sidecar is missing (the process died between the two)
is skipped by :meth:`Checkpointer.restore` for the newest older step that
has both.  The newest ``keep`` steps are kept.

The layout is the port's own: ``fvt_tpu`` saves through orbax, and a
checkpoint of one package does not resume a run of the other.  A
finished run's best models (``best-models/<case>/model.msgpack``) are
``fvt_tpu``'s format and are read by both.
"""
from __future__ import annotations

import os
import pickle
import re
from os.path import join
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fvt_tpu_torch.train.metrics import PerfTracker
from fvt_tpu_torch.utils.logger import log

_STATE = re.compile(r'state_(\d+)\.pt')


def _tracker_state(t: PerfTracker) -> dict:
    return {
        'first': t.first,
        'master_ignore_class': t.master_ignore_class,
        'master_metric': t.master_metric,
        'master_level': t.master_level,
        'master_video_pred': t.master_video_pred,
        'best_value': t.best_value,
        'best_value_idx': t.best_value_idx,
        'cnt': t.cnt,
        'is_last_best': t.is_last_best,
        'current_status_str': t.current_status_str,
        'best_status_str': t.best_status_str,
        'holder_list': t.holder_list,
    }


def _restore_tracker(state: dict) -> PerfTracker:
    t = PerfTracker(master_ignore_class=state['master_ignore_class'],
                    master_metric=state['master_metric'],
                    master_level=state['master_level'],
                    master_video_pred=state['master_video_pred'])
    for k, v in state.items():
        setattr(t, k, v)
    return t


def _atomic(path: str, write) -> None:
    tmp = f'{path}.tmp'
    with open(tmp, 'wb') as f:
        write(f)
    os.replace(tmp, path)


class Checkpointer:
    def __init__(self, outd: str, every: int = 1, keep: int = 2):
        self.dir = join(outd, 'checkpoints')
        self.every = max(1, every)
        self.keep = keep
        self.allow_restore = True
        # the early stopper's countdown of the restored step (None for a
        # checkpoint without one)
        self.restored_stopper_counter: Optional[int] = None
        os.makedirs(self.dir, exist_ok=True)

    def should_save(self, epoch: int) -> bool:
        return (epoch + 1) % self.every == 0

    def all_steps(self) -> list:
        """The epochs with a tensor file, oldest first."""
        return sorted(int(m[1]) for m in map(_STATE.fullmatch,
                                              os.listdir(self.dir)) if m)

    def latest_epoch(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, epoch: int, trainer, trackers: Dict[Any, PerfTracker],
             best: Dict[Any, Dict[str, torch.Tensor]], loss_tracker: list,
             scheduler=None, stopper_counter: Optional[int] = None) -> None:
        """Saves ``trainer``'s model, optimizer and step count, and the
        run's bookkeeping, as epoch ``epoch``."""
        arrays = {'model': trainer.model.state_dict(),
                  'optimizer': trainer.optimizer.state_dict(),
                  'step': trainer.train_step.step}
        meta = {
            'epoch': epoch,
            'loss_tracker': list(loss_tracker),
            'trackers': {str(k): _tracker_state(t)
                         for k, t in trackers.items()},
            'tracker_keys': {str(k): k for k in trackers},
            'best': {str(k): {n: t.numpy() for n, t in copy.items()}
                     for k, copy in best.items()},
            'scheduler': scheduler.state_dict() if scheduler else {},
            'stopper_counter': stopper_counter,
        }
        _atomic(join(self.dir, f'state_{epoch}.pt'),
                lambda f: torch.save(arrays, f))
        _atomic(join(self.dir, f'meta_{epoch}.pkl'),
                lambda f: pickle.dump(meta, f,
                                      protocol=pickle.HIGHEST_PROTOCOL))
        live = self.all_steps()[-self.keep:]
        for name in os.listdir(self.dir):
            m = re.fullmatch(r'(?:state_(\d+)\.pt|meta_(\d+)\.pkl)', name)
            if m and int(m[1] or m[2]) not in live:
                os.remove(join(self.dir, name))
        log(f"checkpoint saved at epoch {epoch} -> {self.dir}")

    def restore(self, trainer, scheduler=None) -> Optional[Tuple]:
        """Loads the newest complete step into ``trainer`` (model,
        optimizer, step count) and ``scheduler`` in place; returns
        (epoch, trackers, best-model copies, loss history), or None when
        no step has both files."""
        for step in reversed(self.all_steps()):
            path = join(self.dir, f'meta_{step}.pkl')
            if os.path.isfile(path):
                break
            log(f"WARNING: checkpoint step {step} has its tensors but no "
                f"meta sidecar (crash mid-save?); trying an older step")
        else:
            return None
        with open(path, 'rb') as f:
            meta = pickle.load(f)
        arrays = torch.load(join(self.dir, f'state_{step}.pt'),
                            map_location=trainer.device, weights_only=True)
        trainer.model.load_state_dict(arrays['model'], strict=True)
        trainer.optimizer.load_state_dict(arrays['optimizer'])
        trainer.train_step.step = int(arrays['step'])
        trackers = {meta['tracker_keys'][ks]: _restore_tracker(ts)
                    for ks, ts in meta['trackers'].items()}
        best = {meta['tracker_keys'][ks]: {n: torch.from_numpy(np.array(a))
                                           for n, a in copy.items()}
                for ks, copy in meta['best'].items()}
        if scheduler is not None and meta.get('scheduler'):
            scheduler.load_state_dict(meta['scheduler'])
        self.restored_stopper_counter = meta.get('stopper_counter')
        log(f"restored checkpoint from epoch {meta['epoch']}")
        return meta['epoch'], trackers, best, meta['loss_tracker']
