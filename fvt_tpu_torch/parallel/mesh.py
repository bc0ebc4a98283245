"""The process group of the port's data-parallel training (the counterpart
of ``fvt_tpu/parallel/mesh.py``, whose one ``data`` axis over the local
devices becomes one process per GPU over ``torch.distributed``).

A rank's device is ``cuda:LOCAL_RANK`` unless the caller names one, and the
backend follows the device: ``nccl`` on the card, ``gloo`` on the CPU.
Nothing falls back: if ``nccl`` fails to start, the run fails.  The group
comes from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), from :func:`spawn`, which
sets that environment for each process it starts, from a group the caller
started before (:func:`join` takes it as it is, whatever its backend), or
from :func:`join_at`'s port and timeout (the serving group,
``parallel/serving.py``).

No port is chosen first and bound later by another process: another
process's socket could take it in between.  The process that starts the
others hosts the group's store on a port the system picks as it binds
(:func:`host_store`) and hands its number on: :func:`spawn` as
``MASTER_PORT``, every spawned rank a client of it (``torchrun``'s agent
store), and ``serving.start`` as :func:`join_at`'s port.

``fvt_tpu``'s ``replicated`` and ``batch_sharded`` shardings have no
counterpart here: parameters are replicated by DDP, and a rank holds its
rows of a batch as plain tensors (:func:`shard_batch`).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from fvt_tpu_torch.parallel.multihost import host_slice

ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')


@dataclass(frozen=True)
class World:
    """This process's place in the group: its rank, the world's size, its
    local rank and device, the group's backend, and whether :func:`join`
    started the group (and :func:`leave` ends it)."""
    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str
    owned: bool = False

    @property
    def writer(self) -> bool:
        """Only rank 0 writes the run's files."""
        return self.rank == 0


def backend_for(device) -> str:
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def in_env() -> bool:
    """True inside ``torchrun`` or a :func:`spawn`: the group's
    environment is set."""
    return all(k in os.environ for k in ('RANK', 'WORLD_SIZE'))


def join(device=None) -> Optional[World]:
    """This process's :class:`World`: of the group already started, or of
    the one the environment describes, started here with ``device``'s
    backend (``device`` None: ``cuda:LOCAL_RANK``).  None without
    either."""
    owned = False
    if not dist.is_initialized():
        if not in_env():
            return None
        local = int(os.environ.get('LOCAL_RANK', 0))
        device = torch.device('cuda', local) if device is None \
            else torch.device(device)
        if device.type == 'cuda':
            torch.cuda.set_device(device)
        dist.init_process_group(backend_for(device), init_method='env://')
        owned = True
    local = int(os.environ.get('LOCAL_RANK', dist.get_rank()))
    if device is None:
        device = torch.device('cuda', local)
    return World(dist.get_rank(), dist.get_world_size(), local,
                 torch.device(device), dist.get_backend(), owned)


def host_store(timeout_s: Optional[float] = None) -> dist.TCPStore:
    """A group's store, hosted by this process on a port the system picks
    as it binds (``.port``), so that no other socket can take it first;
    a wait on it longer than ``timeout_s`` (default 300 s) fails."""
    return dist.TCPStore('localhost', 0, None, True,
                         timeout=timedelta(seconds=timeout_s or 300.0),
                         wait_for_workers=False)


def join_at(rank: int, size: int, port: int, device,
            timeout_s: Optional[float] = None,
            store: Optional[dist.TCPStore] = None) -> World:
    """Starts the group of ``size`` ranks whose store is ``store``, which
    this process hosts (:func:`host_store`), or else the one at
    ``localhost:<port>``, as ``rank`` on ``device`` with its backend (a
    serving group, ``parallel/serving.py``); a collective or a wait on
    the store longer than ``timeout_s`` fails.  The :class:`World` owns
    the group."""
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    timeout = timedelta(seconds=timeout_s or 300.0)
    if store is None:
        store = dist.TCPStore('localhost', port, size, False,
                              timeout=timeout)
    kw = {} if timeout_s is None else {'timeout': timeout}
    dist.init_process_group(backend_for(device), store=store, rank=rank,
                            world_size=size, **kw)
    return World(rank, size, rank, device, dist.get_backend(), owned=True)


def leave(world: Optional[World]) -> None:
    """Ends the group if :func:`join` started it."""
    if world is not None and world.owned and dist.is_initialized():
        dist.destroy_process_group()


def barrier(world: Optional[World]) -> None:
    if world is not None and world.size > 1:
        dist.barrier()


def broadcast(world: Optional[World], obj):
    """Rank 0's ``obj`` on every rank."""
    if world is None or world.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shard_batch(batch: Dict[str, np.ndarray], world: World
                ) -> Dict[str, np.ndarray]:
    """This rank's rows of a host batch (all of them where the world size
    does not divide its rows: the batch then runs replicated)."""
    rows = next(iter(batch.values())).shape[0]
    sl = host_slice(rows, world.rank, world.size)
    if sl is None:
        return batch
    return {k: v[sl[0]:sl[1]] for k, v in batch.items()}


def _spawned(rank: int, fn: Callable, nprocs: int, port: int,
             args: tuple) -> None:
    # every rank, rank 0 too, a client of the store that spawn hosts
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(nprocs), MASTER_ADDR='localhost',
                      MASTER_PORT=str(port),
                      TORCHELASTIC_USE_AGENT_STORE='True')
    fn(*args)


def spawn(fn: Callable, nprocs: int, *args,
          timeout_s: Optional[float] = None) -> None:
    """Runs ``fn(*args)`` in ``nprocs`` new processes with the group's
    environment set (rank i on ``cuda:i`` once it calls :func:`join`);
    returns when all have ended, and raises if one failed, or, past
    ``timeout_s``, ends them all and raises TimeoutError.  This process
    hosts the group's store (:func:`host_store`) until then."""
    store = host_store(timeout_s)
    ctx = torch.multiprocessing.spawn(
        _spawned, args=(fn, nprocs, store.port, args), nprocs=nprocs,
        join=False)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(f'{nprocs} ranks of {fn.__name__} still ran '
                               f'after {timeout_s} s: ended')
