"""What ``--serve_quant int8`` and ``int8_static`` change in the served
result: the port's counterpart of ``tools/quant_delta.py``.

    python3 -m fvt_tpu_torch.tools.quant_delta [--lengths 300 700 ...]
        [--workdir <dir>] [--device cpu]

Writes a synthetic C-EXPR-DB-CHALLENGE store of 256^2 face crops
(``tools/synth_store.py``, the disk contract's size, resized on the host),
builds the tri-modal LFAN (``video+vggish+bert``) with its weights drawn
from the seed (``fvt_tpu``'s ports a torch backbone from the reference
checkpoint, which is absent here: every weight here is random, the
backbone's too), and runs challenge inference through
``Experiment``/``Trainer.inference`` three times on the same weights:
``--amp`` (the bfloat16 backbone, the reference), ``--amp --serve_quant
int8`` and ``--amp --serve_quant int8_static`` (calibrated on the loaded
weights, as ``Experiment.run_eval`` does).  Prints one JSON line: for
each int8 mode the per-frame logit delta against the bf16 run (max and
mean of ``|bf16 - int8|`` over every frame of every video), the frame
argmax agreement, and the frame- and video-level W-F1 of both against the
store's labels with their deltas; beside them the mean |logit| of the
bf16 run, for scale.  Runs on the card unless ``--device cpu`` is given.
Deltas on trained weights wait for the published ArcFace weights.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from types import SimpleNamespace

import numpy as np

from fvt_tpu_torch import constants
from fvt_tpu_torch.config.defaults import get_config
from fvt_tpu_torch.tools.synth_store import make_cexpr_store

MODALITY = 'video+vggish+bert+EXPR_continuous_label'
MODES = ('int8', 'int8_static')


def run_inference(serve_quant: str, store: dict, outd: str, device,
                  lengths_window: tuple) -> tuple:
    """(perf, per-video logits) of challenge inference on the store under
    ``--amp --serve_quant <serve_quant>``."""
    from fvt_tpu_torch.experiment import Experiment

    window, hop = lengths_window
    cfg = get_config(constants.C_EXPR_DB_CHALLENGE)
    cfg.update(dataset_path=store['dataset_path'],
               folds_dir=store['folds_dir'], modality=MODALITY, amp=True,
               serve_quant=serve_quant, window_length=window,
               hop_length=hop, eval_bucket_quantum=100, eval_video_batch=32,
               num_workers=4, calc_mean_std=True, outd=outd, seed=0)
    exp = Experiment(SimpleNamespace(**cfg), device)
    exp.prepare()
    loaders = exp.init_loaders()
    trainer = exp.init_trainer()
    if serve_quant == 'int8_static':
        trainer.calibrate_quant(exp.sample_batch(loaders))
    return trainer.inference(loaders[constants.TESTSET])


def wf1(perf: dict, level: str) -> float:
    """The master W-F1 at ``level``; at video level, of the frame vote
    (the trackers' master video prediction)."""
    entry = perf[None][constants.W_F1][level]
    if level == constants.VIDEO_LEVEL:
        entry = entry[constants.FRM_VOTE]
    return float(entry['master'])


def delta_report(runs: dict) -> dict:
    """The JSON line of ``runs`` ({'bf16' | mode: (perf, logits)})."""
    perf_ref, ref = runs['bf16']
    out = {'videos': len(ref),
           'frames': int(sum(len(v['logits']) for v in ref.values())),
           'logit_scale': float(np.mean(np.concatenate(
               [np.abs(v['logits']).reshape(-1) for v in ref.values()])))}
    for level, key in ((constants.FRAME_LEVEL, 'frame'),
                       (constants.VIDEO_LEVEL, 'video')):
        out[f'wf1_{key}_bf16'] = wf1(perf_ref, level)
    for mode in MODES:
        perf_q, q = runs[mode]
        d = np.concatenate([np.abs(ref[v]['logits'] - q[v]['logits'])
                            .reshape(-1) for v in ref])
        agree = np.concatenate([ref[v]['logits'].argmax(-1)
                                == q[v]['logits'].argmax(-1) for v in ref])
        out.update({f'logit_abs_delta_max_{mode}': float(d.max()),
                    f'logit_abs_delta_mean_{mode}': float(d.mean()),
                    f'frame_argmax_agreement_{mode}': float(agree.mean())})
        for level, key in ((constants.FRAME_LEVEL, 'frame'),
                           (constants.VIDEO_LEVEL, 'video')):
            got = wf1(perf_q, level)
            out[f'wf1_{key}_{mode}'] = got
            out[f'wf1_{key}_delta_{mode}'] = got - out[f'wf1_{key}_bf16']
    return out


def main(argv=None, device=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--lengths', type=int, nargs='+',
                   default=[60, 150, 299, 300, 450, 700, 1000, 1500])
    p.add_argument('--window', type=int, default=300)
    p.add_argument('--hop', type=int, default=200)
    p.add_argument('--workdir', default=None)
    p.add_argument('--device', default=None)
    a = p.parse_args(argv)
    device = a.device or device
    if device is None:
        import torch
        if not torch.cuda.is_available():
            print('quant_delta: no CUDA device (--device cpu runs the plain '
                  'versions)', file=sys.stderr)
            raise SystemExit(1)
    work = a.workdir or tempfile.mkdtemp(prefix='fvt_torch_qd_')
    store = make_cexpr_store(os.path.join(work, 'store'), a.lengths,
                             video_hw=256)
    runs = {mode: run_inference('none' if mode == 'bf16' else mode, store,
                                os.path.join(work, mode), device,
                                (a.window, a.hop))
            for mode in ('bf16',) + MODES}
    out = delta_report(runs)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
