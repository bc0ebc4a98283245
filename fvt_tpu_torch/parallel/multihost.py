"""Row slices of a data-parallel job (the counterpart of
``fvt_tpu/parallel/multihost.py``).

The port runs one process per GPU, so every rank is what a host is to
``fvt_tpu``: every rank derives the same batch plan from the seed
(``TrainLoader._plan`` is a pure function of (seed, epoch)) and builds
only its contiguous row slice of each global batch
(``TrainLoader.epoch_local``); a batch whose rows the world size does not
divide is built whole on every rank and runs replicated
(``parallel/dp.py``).  With one process everything is the single-process
behaviour.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist


def process_info() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_slice(global_rows: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None
               ) -> Optional[Tuple[int, int]]:
    """[start, stop) of the rows this process owns, or None when the
    batch is not evenly divisible (callers replicate it instead)."""
    if process_index is None or process_count is None:
        process_index, process_count = process_info()
    if process_count <= 1:
        return 0, global_rows
    if global_rows % process_count:
        return None
    per = global_rows // process_count
    return process_index * per, (process_index + 1) * per
