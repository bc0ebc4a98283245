"""Mini cross-validation campaign through the whole port
(``tools/cv_campaign.py`` of ``fvt_tpu``, through the port's CLIs).

Upstream's C-EXPR-DB protocol is 5-fold CV (its folds/ tree) whose
summaries it leaves to hand-work.  This tool runs the real pipeline end
to end: ``folds x seeds`` trainings through ``python -m
fvt_tpu_torch.main`` on one synthetic non-separable C-EXPR-DB store
(``tools/synth_store.make_cexpr_store``'s hardness knobs, seed 300),
each gated on its run's ``passed.txt`` (its output kept in
``<run dir>.log``, whose end a failed run prints), then aggregated by
``tools/summarize_runs.py`` into the per-fold rows and the mean +/- std
table, printed and optionally written as markdown.  Every run is on the
card unless ``--device cpu`` is given::

    python -m fvt_tpu_torch.tools.cv_campaign [--workdir DIR] [--folds 2]
        [--seeds 0,1] [--epochs 6] [--out CV_CAMPAIGN.md] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from os.path import join
from typing import Optional, Sequence

from fvt_tpu_torch.tools import summarize_runs as sr
from fvt_tpu_torch.tools.synth_store import make_cexpr_store

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(workdir: Optional[str] = None, folds: int = 2,
         seeds: Sequence[int] = (0, 1), epochs: int = 6,
         out_md: Optional[str] = None, device: Optional[str] = None
         ) -> dict:
    """Runs the campaign; returns ``summarize_runs.summarize``'s summary
    with its rendered table under ``'table'``."""
    workdir = workdir or join(tempfile.gettempdir(), 'fvt_torch_cv')
    if os.path.isdir(workdir):
        shutil.rmtree(workdir)
    store = make_cexpr_store(join(workdir, 'store'), ds='C-EXPR-DB',
                             n_train=40, n_val=16, min_len=8, max_len=30,
                             seed=300, separation=0.8, label_noise=0.25,
                             ambiguity=0.25, n_folds=folds, video_hw=8)
    exps = join(workdir, 'exps')
    for fold in range(folds):
        for seed in seeds:
            outd = join(exps, f'fold{fold}_seed{seed}')
            print(f'== cv_campaign: fold {fold} seed {seed} '
                  f'({epochs} epochs) ==', flush=True)
            cmd = [sys.executable, '-m', 'fvt_tpu_torch.main',
                   '--dataset_name', 'C-EXPR-DB',
                   '--dataset_path', store['dataset_path'],
                   '--folds_dir', store['folds_dir'],
                   '--fold_to_run', str(fold), '--seed', str(seed),
                   '--modality', 'vggish+bert+EXPR_continuous_label',
                   '--model_name', 'LFAN', '--use_other_class', 'true',
                   '--num_epochs', str(epochs),
                   '--train_batch_size', '4', '--num_workers', '1',
                   '--window_length', '16', '--hop_length', '8',
                   '--eval_bucket_quantum', '16',
                   '--eval_window_batch', '4', '--outd', outd]
            if device:
                cmd += ['--device', device]
            # the run's whole output, kept beside its run directory
            log_path = f'{outd}.log'
            os.makedirs(exps, exist_ok=True)
            with open(log_path, 'w') as log:
                r = subprocess.run(cmd, cwd=REPO, stdout=log,
                                   stderr=subprocess.STDOUT, timeout=1800)
            if r.returncode != 0:
                with open(log_path, errors='replace') as log:
                    print(log.read()[-6000:])
                raise SystemExit(f'fold {fold} seed {seed} failed: exit '
                                 f'{r.returncode} (a negative code is the '
                                 f'signal that ended it); {log_path}')
            assert os.path.isfile(join(outd, 'passed.txt')), outd

    summary = sr.summarize([exps])
    table = sr.render(summary)
    assert len(summary['runs']) == folds * len(seeds) * 2, \
        (len(summary['runs']), 'expect 2 selection items per run')
    header = (f'CV campaign: {folds} folds x {list(seeds)} seeds, '
              f'{epochs} epochs, synthetic non-separable C-EXPR-DB '
              f'store (separation=0.8, label_noise=0.25, '
              f'ambiguity=0.25, 56 trials)\n'
              f'command: python -m fvt_tpu_torch.tools.cv_campaign '
              f'--folds {folds} --seeds {",".join(map(str, seeds))} '
              f'--epochs {epochs}\n')
    print(header)
    print(table)
    if out_md:
        with open(out_md, 'w') as f:
            f.write('# Mini CV campaign (real runs, aggregated)\n\n'
                    + header + '\n```\n' + table + '\n```\n')
        print(f'wrote {out_md}')
    summary['table'] = table
    return summary


if __name__ == '__main__':
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workdir', default=None,
                   help='default: fvt_torch_cv in the temp dir')
    p.add_argument('--folds', type=int, default=2)
    p.add_argument('--seeds', default='0,1')
    p.add_argument('--epochs', type=int, default=6)
    p.add_argument('--out', default=None)
    p.add_argument('--device', default=None,
                   help="the runs' device: the card by default")
    a = p.parse_args()
    main(a.workdir, a.folds, tuple(int(s) for s in a.seeds.split(',')),
         a.epochs, a.out, a.device)
