"""Export a finished training run's best model as a frozen serving artifact
(``tools/export_serving.py`` of ``fvt_tpu``; the format is
``fvt_tpu_torch/export.py``'s).

    python -m fvt_tpu_torch.tools.export_serving --fd_exp <run-dir> \\
        [--case_best_model <item>] [--out artifact.fvtserve] \\
        [--window_batch 8 [--window_batch 16 ...]] [--seq_len 300 ...]

Needs the run directory only: its ``config.yml`` (read by
``config/flat_yaml.py``) and ``best-models/<case>/model.msgpack`` (or an
upstream ``model.pt``).  The model is built from the config, the weights
loaded strictly, and the artifact written to ``<fd_exp>/serving.fvtserve``
by default, one shape per ``--window_batch`` x ``--seq_len``.  Nothing is
computed, so no device is used.  Prints one JSON line.  ``--aot`` and
``--platforms`` other than ``cuda`` raise: an XLA executable and StableHLO
for cpu or tpu do not carry over.  A run with ``--serve_quant`` or
``--h2d_bf16_features`` raises too (ROADMAP.md A5).
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


def main(argv=None) -> dict:
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
    a = p.parse_args(argv)
    platforms = check_platforms(
        [s.strip() for s in a.platforms.split(',') if s.strip()], a.aot)

    args = load_run_config(a.fd_exp)
    path_model = best_model_path(a.fd_exp, a.case_best_model)
    wbs = a.window_batch or [int(getattr(args, 'eval_window_batch', 8))]
    tls = a.seq_len or [int(args.window_length)]
    meta = build_meta(args, [(wb, t) for wb in wbs for t in tls], platforms)
    meta['source_run'] = os.path.abspath(a.fd_exp)
    meta['case_best_model'] = os.path.basename(os.path.dirname(path_model))

    model = init_model(args)
    load_best_model(model, path_model, model.modality)
    out = a.out or join(a.fd_exp, 'serving.fvtserve')
    save_artifact(out, meta, model)
    line = {'artifact': out, 'shapes': sorted(meta['shapes']),
            'platforms': platforms, 'aot': []}
    print(json.dumps(line))
    return line


if __name__ == '__main__':
    main(sys.argv[1:])
