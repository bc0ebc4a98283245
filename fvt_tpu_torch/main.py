"""Training CLI of the port (``fvt_tpu/main.py``).

Usage:
  python -m fvt_tpu_torch.main --dataset_name MELD --dataset_path <root> \\
      --modality vggish+bert+EXPR_continuous_label --model_name LFAN ...

It takes ``fvt_tpu.main``'s flags and writes the run directory that
``fvt_tpu.main`` writes; the run trains on the card, and raises without
one (``--device cpu`` takes the CPU).  ``--checkpoint_every N`` saves
the run every N epochs under ``<outd>/checkpoints`` and ``--resume true``
continues the newest one (the port's own checkpoint layout:
``fvt_tpu``'s orbax checkpoints are not read).

``--data_parallel true`` trains data-parallel where ``fvt_tpu`` shards its
step: on more than one visible GPU it starts one process a GPU
(``parallel/mesh.py``'s ``spawn``; the call returns None once they have
ended), and under ``torchrun`` (or in a process group the caller
started) it joins that group, whatever its size::

  torchrun --nproc_per_node N -m fvt_tpu_torch.main --data_parallel true ...

On one GPU it is the single-device run, as in ``fvt_tpu``.
"""
from typing import Optional

import torch

from fvt_tpu_torch.config.parse import build_parser, parse_input
from fvt_tpu_torch.experiment import Experiment
from fvt_tpu_torch.parallel import mesh
from fvt_tpu_torch.train.steps import resolve_device
from fvt_tpu_torch.utils.logger import log


def main(argv=None, device=None) -> Optional[Experiment]:
    """Runs the CLI on ``argv``; ``device`` None is ``--device``, whose
    default is the card (and raises before anything is written when there
    is none).  Returns the
    experiment, whose ``trainer`` holds the run's trackers and losses
    (None in the process that spawned the data-parallel ranks)."""
    flags = build_parser().parse_args(argv)
    data_parallel = bool(flags.data_parallel)
    device = flags.device if device is None else device
    world = mesh.join(device) if data_parallel else None
    if world is None:
        device = resolve_device(device)
        if data_parallel and device.type == 'cuda' \
                and torch.cuda.device_count() > 1:
            mesh.spawn(main, torch.cuda.device_count(), argv)
            return None
    try:
        args = parse_input(argv, world)
        if data_parallel and world is None:
            log('--data_parallel: one device, the single-device run')
        exp = Experiment(args, device, world=world)
        exp.prepare()
        exp.run()
    finally:
        mesh.leave(world)
    return exp


if __name__ == '__main__':
    main()
