"""The data-parallel train step (the counterpart of
``fvt_tpu/parallel/dp.py``): the single-device step body
(``train/steps.py``'s :class:`TrainStep`) under ``DistributedDataParallel``,
one process per GPU, each on its rows of the global batch.

``fvt_tpu``'s DP step is the single-device one on a batch sharded by
GSPMD, which keeps global-array semantics, so DP there equals one device.
The port keeps that equality, which DDP alone does not give:

* BatchNorm's moments span the global batch.  Inside a sharded step
  (``parallel/collectives.py``) the train-mode BatchNorms (each
  modality's and CAN's / JMT's ``bn1``, and the frozen
  ArcFace's, which run under ``torch.no_grad``) take the count, the sum and
  the sum of squares over every rank through an ``all_reduce`` whose
  backward reduces the gradient as well; the running statistics,
  identical on every rank, move with the global moments, so DDP
  broadcasts no buffer.
* Dropout and the crop draws: every rank draws the global batch's masks
  from the step's generator and keeps its rows, so the
  masks are the single device's.
* JMT's and MT's final attention spans the flattened B*T timeline of the
  batch: its input is gathered over the ranks with its gradient and each
  rank keeps its rows of the output.
* The losses: cross-entropy is a mean over B*T and the CCC loss a mean of
  per-sequence terms, so with equal row slices DDP's average of the ranks'
  gradients is the global gradient.  A batch the world size does not
  divide runs whole on every rank under ``no_sync``: every rank then holds
  the same gradient already.
* Parameters the loss does not reach: JMT's and MT's cross-attentions
  other than the last, JMT's visual encoder and the TCNs of modalities
  they do not fuse (:func:`unused_parameters`).  DDP is told so for those
  families only; the step still gives them a zero gradient, as the single
  device does.

The collectives are ``all_reduce`` and ``all_gather``, which ``gloo``
takes on CPU and CUDA tensors and ``nccl`` on the card.
"""
from __future__ import annotations

import contextlib
import hashlib
import inspect
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from fvt_tpu_torch import constants
from fvt_tpu_torch.parallel.collectives import (Rows, all_reduce_sum,
                                                sharded)
from fvt_tpu_torch.train.steps import TrainStep


def unused_parameters(model: nn.Module) -> bool:
    """True for the families whose loss leaves trainable parameters without
    a gradient (JMT and MT; module docstring)."""
    return getattr(model, 'model_name', '') in (constants.JMT, constants.MT)


def _digest(batch: Dict[str, Any]) -> int:
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return int.from_bytes(h.digest()[:8], 'little', signed=True)


def assert_ranks_agree(batch: Dict[str, Any], device) -> None:
    """``--multihost_digest_check`` for a replicated batch: every rank
    must have built the same bytes.  One all-gather of 8 bytes."""
    local = torch.tensor([_digest(batch)], dtype=torch.int64, device=device)
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    got = [int(p.item()) for p in parts]
    if len(set(got)) > 1:
        raise RuntimeError(
            f'data-parallel desync: the replicated batch\'s digests differ '
            f'across ranks: {got} — a rank built different batch bytes '
            f'(stale store? nondeterministic batch build?)')


class DPTrainStep(TrainStep):
    """:class:`~fvt_tpu_torch.train.steps.TrainStep` of ``model`` under
    DDP over the default group, on ``world.device``.  A call takes this
    rank's rows of a global batch of ``global_rows`` rows (all of them for
    a replicated batch) and returns the global batch's loss."""

    def __init__(self, model: nn.Module, hp, world, **kw):
        super().__init__(model, hp, world.device, **kw)
        self.world = world
        # no buffer broadcast before a forward: the running statistics move
        # with the global moments on every rank alike (the keyword's newer
        # name where DDP has it)
        sync = ('forward_sync_buffers' if 'forward_sync_buffers' in
                inspect.signature(DistributedDataParallel).parameters
                else 'broadcast_buffers')
        self.net = DistributedDataParallel(
            self.model,
            device_ids=([world.device.index]
                        if world.device.type == 'cuda' else None),
            find_unused_parameters=unused_parameters(self.model),
            **{sync: False})

    def __call__(self, batch: Dict[str, Any], generator: torch.Generator,
                 global_rows: int):
        local = next(iter(batch.values())).shape[0]
        w = self.world.size
        if local * w == global_rows:
            # one rank: DDP's all-reduce over it, the batch its own
            start = self.world.rank * local
            with (sharded(Rows(global_rows, start, start + local)) if w > 1
                  else contextlib.nullcontext()):
                return all_reduce_sum(super().__call__(batch, generator)) / w
        if local != global_rows:
            raise ValueError(f'{local} of {global_rows} rows on one of '
                             f'{w} ranks')
        with self.net.no_sync():
            return super().__call__(batch, generator)


def shard_rows(n: int, world) -> Tuple[int, int]:
    """[lo, hi): this rank's slice of ``n`` eval rows padded to a multiple
    of the world size (hi may pass n: the padding repeats the last)."""
    per = -(-n // world.size)
    return world.rank * per, (world.rank + 1) * per


def gather_eval(out: torch.Tensor, n: int) -> torch.Tensor:
    """Every rank's eval rows concatenated in rank order, the first ``n``
    kept (the rest is padding)."""
    parts = [torch.empty_like(out) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, out.contiguous())
    return torch.cat(parts)[:n]


def pad_rows(x: torch.Tensor, padded: int) -> torch.Tensor:
    """``x`` with its last row repeated up to ``padded`` rows."""
    if x.shape[0] >= padded:
        return x
    return torch.cat([x, x[-1:].expand((padded - x.shape[0],)
                                       + x.shape[1:])])

