"""Export a finished training run's best model as a frozen serving artifact
(``tools/export_serving.py`` of ``fvt_tpu``; the format is
``fvt_tpu_torch/export.py``'s).

    python -m fvt_tpu_torch.tools.export_serving --fd_exp <run-dir> \\
        [--case_best_model <item>] [--out artifact.fvtserve] \\
        [--window_batch 8 [--window_batch 16 ...]] [--seq_len 300 ...] \\
        [--calib_store <dataset_path>] [--calib_folds_dir <folds>] \\
        [--device cpu]

Needs the run directory only: its ``config.yml`` (read by
``config/flat_yaml.py``) and ``best-models/<case>/model.msgpack`` (or an
upstream ``model.pt``).  The model is built from the config, the weights
loaded strictly, and the artifact written to ``<fd_exp>/serving.fvtserve``
by default, one shape per ``--window_batch`` x ``--seq_len``.  Prints one
JSON line.  ``--aot`` and ``--platforms`` other than ``cuda`` raise: an
XLA executable and StableHLO for cpu or tpu do not carry over.

A ``--serve_quant int8_static`` run also needs a feature store: its
activation scales describe live data, so the export calibrates the loaded
weights on one representative batch of the run's ``dataset_path`` (or
``--calib_store`` / ``--calib_folds_dir``) on the card (or ``--device``)
and writes the scales into the artifact's ``extra_vars``; without a store
it raises.  Every other export computes nothing and uses no device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from os.path import join

from fvt_tpu_torch.export import (PLATFORM, build_meta, check_platforms,
                                  load_run_config, save_artifact)
from fvt_tpu_torch.inference_challenge import best_model_path
from fvt_tpu_torch.models.checkpoint import load_best_model
from fvt_tpu_torch.models.registry import init_model
from fvt_tpu_torch.utils.logger import log


def calibrate(args, model, device) -> dict:
    """``extra_vars`` of an ``int8_static`` export: ``{'act_scales':
    ...}`` from one representative batch of the run's store, on the
    loaded weights (``fvt_tpu``'s ``Experiment.run_eval`` ->
    ``Trainer.calibrate_quant``, the same path)."""
    from fvt_tpu_torch.experiment import Experiment
    from fvt_tpu_torch.models.to_jax import act_scales_to_flax
    from fvt_tpu_torch.serve import calibrate_act_scales

    exp = Experiment(args, device)
    exp.prepare()
    sample = exp.sample_batch(exp.init_loaders())
    model.to(exp.device)
    calibrate_act_scales(model, sample, exp.device)
    log(f'int8_static: calibrated '
        f'{len(model.spatial.visual.int8_convs())} activation scales from '
        f'{args.dataset_path}')
    return {'act_scales': act_scales_to_flax(model)}


def main(argv=None, device=None) -> dict:
    """Runs the CLI on ``argv``; an ``int8_static`` run calibrates on
    ``device`` (or ``--device``; None is the card)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--fd_exp', required=True,
                   help='finished training run dir (config.yml + '
                        'best-models/)')
    p.add_argument('--case_best_model', default=None)
    p.add_argument('--out', default=None,
                   help='artifact path (default <fd_exp>/serving.fvtserve)')
    p.add_argument('--window_batch', type=int, action='append',
                   default=None,
                   help="pooled window-batch size(s) to export (default: "
                        "the run's eval_window_batch)")
    p.add_argument('--seq_len', type=int, action='append', default=None,
                   help="per-window frame count(s) (default: the run's "
                        "window_length)")
    p.add_argument('--platforms', default=PLATFORM)
    p.add_argument('--aot', action='store_true',
                   help='refused: an XLA executable does not carry over')
    p.add_argument('--calib_store', default=None,
                   help="int8_static only: dataset_path holding the "
                        "calibration store (default: the run's "
                        "dataset_path)")
    p.add_argument('--calib_folds_dir', default=None,
                   help="int8_static only: folds_dir for the calibration "
                        "store (default: the run's)")
    p.add_argument('--device', default=None,
                   help='int8_static only: where to calibrate (default: '
                        'the card)')
    a = p.parse_args(argv)
    platforms = check_platforms(
        [s.strip() for s in a.platforms.split(',') if s.strip()], a.aot)

    args = load_run_config(a.fd_exp)
    int8_static = getattr(args, 'serve_quant', 'none') == 'int8_static'
    if int8_static:
        if a.calib_store:
            args.dataset_path = a.calib_store
        if a.calib_folds_dir:
            args.folds_dir = a.calib_folds_dir
        if not os.path.isdir(str(args.dataset_path)):
            raise SystemExit(
                f'int8_static export needs a calibration store: the '
                f'activation scales describe live data '
                f'(experiment.py:243-246) and {args.dataset_path!r} '
                f'does not exist — pass --calib_store/--calib_folds_dir')
    path_model = best_model_path(a.fd_exp, a.case_best_model)
    wbs = a.window_batch or [int(getattr(args, 'eval_window_batch', 8))]
    tls = a.seq_len or [int(args.window_length)]
    meta = build_meta(args, [(wb, t) for wb in wbs for t in tls], platforms)
    meta['source_run'] = os.path.abspath(a.fd_exp)
    meta['case_best_model'] = os.path.basename(os.path.dirname(path_model))

    model = init_model(args)
    load_best_model(model, path_model, model.modality)
    extra_vars = (calibrate(args, model, a.device or device) if int8_static
                  else None)
    out = a.out or join(a.fd_exp, 'serving.fvtserve')
    save_artifact(out, meta, model, extra_vars=extra_vars)
    line = {'artifact': out, 'shapes': sorted(meta['shapes']),
            'platforms': platforms, 'aot': []}
    print(json.dumps(line))
    return line


if __name__ == '__main__':
    main(sys.argv[1:])
