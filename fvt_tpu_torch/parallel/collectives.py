"""The collectives of a sharded data-parallel step or serving call, which
the models, the int8 quantise pass and the train transform call
(``parallel/dp.py`` and ``parallel/serving.py`` say why): the rows of the
global batch a rank computes (:func:`sharded`, :func:`rows`), the
differentiable sum over the ranks (:func:`all_reduce_sum`), the max over
them (:func:`all_reduce_max`), the gathered rows of JMT's and MT's final
attention (:func:`gather_rows`, :func:`own_rows`) and BatchNorm's global
moments (:func:`moments`, :func:`batchnorm_frames`).  Outside a sharded
step each is the identity of the single device (or, for the BatchNorms
and the max, not called).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn


@dataclass(frozen=True)
class Rows:
    """The rows [start, stop) of a global batch of ``total`` rows that
    this rank computes."""
    total: int
    start: int
    stop: int


_ROWS: Optional[Rows] = None


@contextlib.contextmanager
def sharded(rows: Rows) -> Iterator[None]:
    """The forward and backward inside run on ``rows`` of a global batch
    shared over the default group."""
    global _ROWS
    prev, _ROWS = _ROWS, rows
    try:
        yield
    finally:
        _ROWS = prev


def current() -> Optional[Rows]:
    return _ROWS


def rows(n: int) -> Tuple[int, int, int]:
    """(n_global, lo, hi) for a tensor whose leading dimension ``n``
    counts this rank's rows, or its frames (rows times T): draw
    ``n_global`` and keep [lo, hi).  (n, 0, n) outside a sharded step."""
    r = _ROWS
    if r is None:
        return n, 0, n
    local = r.stop - r.start
    per, rem = divmod(n, local)
    if rem:
        raise ValueError(f'{n} is not a multiple of the {local} rows')
    return r.total * per, r.start * per, r.stop * per


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the gradient of a
    rank's copy is the sum of every rank's gradient of the result."""
    return _AllReduceSum.apply(x)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks, without a gradient
    (dynamic int8's per-tensor amax of a sharded call, ``ops/quant.py``):
    a max of floats is exact, so the result is the single call's."""
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.dim, ctx.n = dim, x.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        lo = dist.get_rank() * ctx.n
        return grad.narrow(ctx.dim, lo, ctx.n), None


def gather_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inside a sharded step, every rank's ``x`` concatenated along
    ``dim`` in rank order (the global batch's), differentiable; ``x``
    itself outside one."""
    if _ROWS is None:
        return x
    return _GatherRows.apply(x, dim)


def own_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (see
    :func:`gather_rows`); ``x`` itself outside a sharded step."""
    r = _ROWS
    if r is None:
        return x
    per = x.shape[dim] // r.total
    return x.narrow(dim, r.start * per, (r.stop - r.start) * per)


def moments(x: torch.Tensor, red: List[int]
            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(sum, sum of squares, count) of x over the axes ``red``, summed over
    the ranks inside a sharded step."""
    n = x.numel() // x.shape[1]
    s = torch.stack([x.sum(red), x.square().sum(red)])
    if _ROWS is not None:
        s = all_reduce_sum(s)
        n = n * dist.get_world_size()
    return s[0], s[1], n


def batchnorm_frames(bn: nn.BatchNorm1d, h: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm1d over the (N, C) rows ``h`` of every rank: the
    global mean, the global biased variance (two passes, as
    ``F.batch_norm`` centres before it squares) to normalise, the unbiased
    one into the running EMA at ``bn.momentum``."""
    n = h.shape[0] * dist.get_world_size()
    mean = all_reduce_sum(h.sum(0)) / n
    d = h - mean
    var = all_reduce_sum(d.square().sum(0)) / n
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(m * mean)
        bn.running_var.mul_(1.0 - m).add_(m * var * (n / max(n - 1, 1)))
    return d * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
