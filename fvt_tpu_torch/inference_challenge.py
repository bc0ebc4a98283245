"""Challenge inference CLI of the port (``fvt_tpu/inference_challenge.py``).

Reads a finished TRAINING run's ``config.yml``, retargets it to the
evaluated dataset (C-EXPR-DB-CHALLENGE by default), loads the requested
best model (``model.msgpack`` of ``fvt_tpu``, or an upstream
``model.pt``), runs the eval pass on the card and writes
``pred-C-EXPR-DB-CHALLENGE/prediction.pkl`` and, for every target,
``eval-<set>-perf.pkl``, ``pred-per-frame-eval-<set>.pkl`` and
``eval-<set>-perf.txt`` under ``<fd_exp>/eval-<dataset>`` (or ``--outd``).

Usage:
  python -m fvt_tpu_torch.inference_challenge --mode EVALUATION \\
      --fd_exp <training-run-dir> --target_ds_name C-EXPR-DB-CHALLENGE \\
      --dataset_path <challenge-root> --folds_dir <folds> \\
      [--case_best_model <item>] [--eval_set test] [--outd <dir>] \
      [--device cpu]
"""
from __future__ import annotations

import os
import pickle as pkl
from os.path import join

from fvt_tpu_torch import constants
from fvt_tpu_torch.config.parse import build_parser, parse_input
from fvt_tpu_torch.experiment import Experiment
from fvt_tpu_torch.train import metrics as M


def best_model_path(fd_exp: str, case=None) -> str:
    """``best-models/<case>/model.msgpack``, else ``model.pt``; ``case``
    None takes the first case by name."""
    best_dir = join(fd_exp, 'best-models')
    if case is None:
        cases = sorted(os.listdir(best_dir))
        assert cases, best_dir
        case = cases[0]
    path = join(best_dir, case, 'model.msgpack')
    if not os.path.isfile(path):
        path = join(best_dir, case, 'model.pt')
    return path


def main(argv=None, device=None) -> Experiment:
    """Runs the CLI on ``argv``; ``device`` None is ``--device``, whose
    default is the card (and raises without one).  Returns the experiment, whose ``trainer`` holds the
    pass's ``last_inference_timing``."""
    if device is None:
        device = build_parser().parse_args(argv).device
    args = parse_input(argv)
    assert args.mode == constants.EVALUATION, args.mode

    exp = Experiment(args, device)
    exp.prepare()
    perf, per_video = exp.run_eval(
        best_model_path(args.fd_exp, args.case_best_model))

    write_eval_outputs(args, perf, per_video, exp.data_arranger.int_to_cl)
    return exp


def write_eval_outputs(args, perf: dict, per_video: dict,
                       int_to_cl: dict) -> None:
    """The evaluation persisted for every target under ``args.outd``: the
    nested perf dict, per-frame logits and a readable report."""
    eval_set = getattr(args, 'eval_set', constants.TESTSET)
    with open(join(args.outd, f'eval-{eval_set}-perf.pkl'), 'wb') as f:
        pkl.dump(perf, f, protocol=pkl.HIGHEST_PROTOCOL)
    with open(join(args.outd,
                   f'pred-per-frame-eval-{eval_set}.pkl'), 'wb') as f:
        pkl.dump(per_video, f, protocol=pkl.HIGHEST_PROTOCOL)
    trackers = M.build_trackers(args.dataset_name,
                                getattr(args, 'use_other_class', False))
    reporter = next(iter(trackers.values()))
    with open(join(args.outd, f'eval-{eval_set}-perf.txt'), 'w') as f:
        f.write(reporter.report(perf, int_to_cl))


if __name__ == '__main__':
    main()
