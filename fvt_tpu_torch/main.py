"""Training CLI of the port (``fvt_tpu/main.py``).

Usage:
  python -m fvt_tpu_torch.main --dataset_name MELD --dataset_path <root> \\
      --modality vggish+bert+EXPR_continuous_label --model_name LFAN ...

It takes ``fvt_tpu.main``'s flags and writes the run directory that
``fvt_tpu.main`` writes; the run trains on the card, and raises without
one.  ``--checkpoint_every N`` saves the run every N epochs under
``<outd>/checkpoints`` and ``--resume true`` continues the newest one
(the port's own checkpoint layout: ``fvt_tpu``'s orbax checkpoints are
not read).
"""
from fvt_tpu_torch.config.parse import parse_input
from fvt_tpu_torch.experiment import Experiment
from fvt_tpu_torch.train.steps import resolve_device


def main(argv=None, device=None) -> Experiment:
    """Runs the CLI on ``argv``; ``device`` None is the card (and raises
    before anything is written when there is none).  Returns the
    experiment, whose ``trainer`` holds the run's trackers and losses."""
    device = resolve_device(device)
    args = parse_input(argv)
    exp = Experiment(args, device)
    exp.prepare()
    exp.run()
    return exp


if __name__ == '__main__':
    main()
