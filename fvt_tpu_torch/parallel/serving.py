"""Data-parallel serving of one frozen artifact over ``torch.distributed``
(the counterpart of ``fvt_tpu``'s ``ServingArtifact.call_sharded``,
``fvt_tpu/export.py:345-398``, whose one GSPMD program splits a batch's
rows over a ``data`` mesh and replicates the weights).

The port runs one process a GPU (``parallel/mesh.py``).  Rank 0 is the
process that serves (``tools/serve_http.py``, ``tools/infer_artifact.py``
or any caller of ``ServingArtifact.call_sharded``).  Every other rank holds
the same artifact and runs :func:`follow`: it waits for rank 0's next
call, computes its rows and hands them back, until rank 0 sends the stop
message (:func:`stop`).  :func:`start` makes the calling process rank 0 and
starts the N - 1 followers, on ``cuda:1`` ... ``cuda:N-1`` (or as ``gloo``
ranks on the CPU); a group the caller joined itself serves as well, with
one rank calling and the others following.

One call (:func:`lead` on rank 0, under the artifact's lock, so that the
collectives of two calls never interleave; every rank runs :func:`_run`):

1. rank 0 broadcasts the header, (call, shape index), on the control group;
2. then each input's bytes (a bfloat16 feature as its bits) and, for a JMT
   or MT, the (B,) valid frames, on the default group;
3. every rank computes rows [r*B/N, (r+1)*B/N) under
   ``collectives.sharded``: JMT's and MT's final attention gathers every
   rank's rows and masks (``models/fusion.py``), dynamic int8 takes the
   max of the ranks' amaxes (``ops/quant.py``), so the result is the
   single call's;
4. the (B/N, T, C) logits are gathered in rank order.

The control group is a ``gloo`` group with a timeout of IDLE_TIMEOUT, on
which the followers wait between calls however long the server idles.  The
default group keeps the timeout it was started with (TIMEOUT_S by
:func:`start`), so a rank that died fails the call instead of hanging it.
Nothing falls back: a group that does not start fails the run.
"""
from __future__ import annotations

import multiprocessing
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from fvt_tpu_torch.parallel import collectives, mesh
from fvt_tpu_torch.serve import serving_forward, valid_frames
from fvt_tpu_torch.train.steps import resolve_device

# a collective of the default group that waits this long fails the call
TIMEOUT_S = 300.0
# how long a follower waits for the next call
IDLE_TIMEOUT = timedelta(days=365)
_STOP, _CALL = 0, 1
_DTYPES = {'uint8': torch.uint8, 'float32': torch.float32,
           'bfloat16': torch.bfloat16}
# (the default group, its control group); torch.distributed's default group
# is itself one a process
_control = None


def control(world: mesh.World, ok: bool = True):
    """The control group of the default group, made by every rank together
    on first use, when each says whether it holds its artifact (``ok``):
    raises on every rank that does if one does not (that one raises its
    own error)."""
    global _control
    if _control is not None and _control[0] is dist.group.WORLD:
        return _control[1]
    group = dist.new_group(backend='gloo', timeout=IDLE_TIMEOUT)
    parts = [torch.zeros(1, dtype=torch.int64) for _ in range(world.size)]
    dist.all_gather(parts, torch.tensor([int(ok)]), group=group)
    failed = [r for r, p in enumerate(parts) if not p.item()]
    if failed and ok:
        raise RuntimeError(f'ranks {failed} of the serving group hold no '
                           f'artifact: their load failed (their error '
                           f'output says why)')
    _control = (dist.group.WORLD, group)
    return group


def devices(device, n: int) -> List[torch.device]:
    """The devices of an ``n``-rank serving group whose rank 0 serves on
    ``device`` (None: the card): ``cuda:0`` ... ``cuda:n-1``, refused
    beyond the visible cards, or ``n`` ranks on the CPU."""
    device = resolve_device(device)
    if device.type == 'cpu':
        return [device] * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f'--mesh {n}: need {n} devices, have {have}')
    if device.index not in (None, 0):
        raise ValueError(f'--mesh {n}: rank 0 serves on cuda:0, not '
                         f'{device}')
    return [torch.device('cuda', i) for i in range(n)]


def _nbytes(spec: dict) -> int:
    return int(np.prod(spec['shape'])) * _DTYPES[spec['dtype']].itemsize


def _broadcast(array: Optional[np.ndarray], nbytes: int,
               comm: torch.device) -> torch.Tensor:
    """Rank 0's ``array`` as ``nbytes`` uint8 on ``comm`` on every rank."""
    if array is None:
        buf = torch.empty(nbytes, dtype=torch.uint8, device=comm)
    else:
        buf = torch.from_numpy(np.ascontiguousarray(array).reshape(-1)
                               .view(np.uint8)).to(comm)
    dist.broadcast(buf, 0)
    return buf


def _rows(buf: torch.Tensor, b: int, lo: int, hi: int, dtype: torch.dtype,
          shape, device) -> torch.Tensor:
    """Rows [lo, hi) of the (b, ...) array whose bytes ``buf`` holds, as a
    new tensor of ``dtype`` on ``device``."""
    rows = buf.view(b, -1)[lo:hi].to(device, copy=True)
    return rows.view(dtype).reshape((hi - lo,) + tuple(shape[1:]))


def _run(art, world: mesh.World, key: str,
         arrays: Optional[Dict[str, np.ndarray]],
         lengths: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Steps 2-4 of a call on every rank: (B, T, C) float32 logits on rank
    0, None on the others."""
    specs = art.shape_specs[key]
    b, t = next(iter(specs.values()))['shape'][:2]
    per = b // world.size
    lo, hi = world.rank * per, (world.rank + 1) * per
    comm = world.device if world.backend == 'nccl' else torch.device('cpu')
    with torch.inference_mode():
        batch = {k: _rows(_broadcast(None if arrays is None else arrays[k],
                                     _nbytes(spec), comm),
                          b, lo, hi, _DTYPES[spec['dtype']], spec['shape'],
                          art.device)
                 for k, spec in specs.items()}
        time_mask = None
        if art.needs_mask:
            mine = _rows(_broadcast(lengths, 8 * b, comm), b, lo, hi,
                         torch.int64, (b,), art.device)
            time_mask = valid_frames(mine, t, art.device)
        with collectives.sharded(collectives.Rows(b, lo, hi)):
            out = serving_forward(art.model, batch, time_mask=time_mask)
        out = out.to(comm).contiguous()
        parts = [torch.empty_like(out) for _ in range(world.size)]
        dist.all_gather(parts, out)
        return torch.cat(parts).cpu().numpy() if world.rank == 0 else None


def lead(art, world: mesh.World, key: str, arrays: Dict[str, np.ndarray],
         lengths: Optional[np.ndarray]) -> np.ndarray:
    """Rank 0's side of one call of ``art`` at shape ``key`` on the host
    ``arrays`` and ``lengths`` (``ServingModel.host_inputs``); the caller
    holds ``art``'s lock.  (B, T, C) float32 logits."""
    if world.rank != 0:
        raise RuntimeError(f'rank {world.rank} follows (serving.follow): '
                           f'rank 0 calls')
    dist.broadcast(torch.tensor([_CALL, art.shape_keys.index(key)]), 0,
                   group=control(world))
    return _run(art, world, key, arrays, lengths)


def follow(art, world: mesh.World) -> int:
    """A follower's loop: computes its rows of each of rank 0's calls of
    ``art`` (the same artifact, on this rank's device) until the stop
    message.  Returns the calls it served."""
    group = control(world)
    calls = 0
    while True:
        header = torch.zeros(2, dtype=torch.int64)
        dist.broadcast(header, 0, group=group)
        if int(header[0]) == _STOP:
            return calls
        _run(art, world, art.shape_keys[int(header[1])], None, None)
        calls += 1


def stop(world: mesh.World) -> None:
    """Rank 0 ends every follower's loop; the caller holds the served
    artifact's lock (``ServingArtifact.stop_followers``)."""
    dist.broadcast(torch.tensor([_STOP, 0]), 0, group=control(world))


def _follower(rank: int, size: int, port: int, device: str, path: str,
              config, threads: int) -> None:
    """A process :func:`start` began: joins the group, loads the artifact
    on ``device``, follows, leaves."""
    from fvt_tpu_torch.export import load_artifact
    torch.set_num_threads(threads)
    world = mesh.join_at(rank, size, port, device, TIMEOUT_S)
    try:
        try:
            art = load_artifact(path, device=device, config=config)
        except BaseException:
            control(world, ok=False)
            raise
        follow(art, world)
    finally:
        mesh.leave(world)


@dataclass
class Group:
    """Rank 0's hold on a serving group that :func:`start` began: the
    artifact it serves, its :class:`~fvt_tpu_torch.parallel.mesh.World`
    and the follower processes.  :meth:`close` ends it."""
    art: object
    world: mesh.World
    procs: List[multiprocessing.Process]

    def close(self) -> None:
        """Stops the followers, waits for them (ending any still running
        after TIMEOUT_S) and ends the group.  Raises if a follower
        failed."""
        try:
            self.art.stop_followers(self.world)
        finally:
            _end(self.procs, self.world, TIMEOUT_S)
        failed = {p.name: p.exitcode for p in self.procs if p.exitcode}
        if failed:
            raise RuntimeError(f'serving followers failed: {failed}')


def _end(procs, world: Optional[mesh.World], timeout_s: float) -> None:
    for p in procs:
        p.join(timeout_s)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    mesh.leave(world)


def start(path: str, n: int, device=None, config=None) -> Group:
    """Serves the artifact at ``path`` over ``n`` ranks: this process is
    rank 0 on ``device`` (None: the card, which must then be ``cuda:0``)
    and loads it there; ``n`` - 1 new processes load it on the next cards
    (or on the CPU) and follow.  ``config`` builds an artifact without
    ``model_args`` (``export.model_args``).  A rank that has not joined
    within TIMEOUT_S fails the start."""
    from fvt_tpu_torch.export import load_artifact
    from fvt_tpu_torch.kernels import build
    devs = devices(device, n)
    if devs[0].type == 'cuda':
        build.build()  # once, before the followers look for the library
    store = mesh.host_store(TIMEOUT_S)  # bound before a follower looks
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_follower, name=f'fvt-serving-rank{r}',
                         args=(r, n, store.port, str(devs[r]), path, config,
                               torch.get_num_threads()),
                         daemon=True)
             for r in range(1, n)]
    for p in procs:
        p.start()
    world = None
    try:
        world = mesh.join_at(0, n, store.port, devs[0], TIMEOUT_S, store)
        try:
            art = load_artifact(path, device=devs[0], config=config)
        except BaseException:
            control(world, ok=False)
            raise
        control(world)
    except BaseException:
        for p in procs:
            p.terminate()
        _end(procs, world, 10)
        raise
    return Group(art, world, procs)
