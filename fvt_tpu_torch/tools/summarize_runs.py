"""Cross-run / cross-fold results aggregator: a copy of
``tools/summarize_runs.py`` on the port's modules, reading ``config.yml``
through ``config/flat_yaml`` (the port does not need PyYAML).  It
reads the run directories of either package, which write the same
artifact contract.

Upstream leaves summarizing multi-fold experiments to hand-work:
each run dir holds ``test-<item>-perf.{txt,pkl}`` (one per selection
criterion, upstream trainer.py:716-750) and a ``passed.txt``
completion gate (upstream parseit.py:311-315), but nothing
aggregates the 5-fold C-EXPR-DB CV or a seed sweep into one table.
This tool does:

* discover completed run dirs (``passed.txt`` + ``config.yml`` +
  at least one ``test-*-perf.pkl``; ``--include_unfinished`` lifts the
  gate with a warning, mirroring upstream's refusal to re-enter a
  passed run),
* extract, per selection item, the run's MASTER scalar (the exact
  selection semantics of ``train.metrics.build_trackers``: C-EXPR-DB ->
  frame-level W-F1 per ignore-class, MELD -> video-level W-F1 per
  aggregation rule) plus the standard scalar spread (frame-level
  W-F1 / macro-F1 / class-acc and video-level W-F1 under all three
  aggregation rules),
* group by (dataset, model, modality, item) and report per-fold rows
  plus mean +/- std (population, ddof=0) over the group,
* render texttable-style ASCII (upstream's report look) and
  optionally ``--json``.

Usage::

    python -m fvt_tpu_torch.tools.summarize_runs --roots exps/ [more roots...] \
        [--json summary.json] [--include_unfinished]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import sys
from os.path import isfile, join

import numpy as np

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import flat_yaml
from fvt_tpu_torch.utils.tables import draw_table

# the scalar columns every row carries (master first; CFUSE_MARIX is a
# matrix and deliberately excluded)
COLUMNS = ['master',
           'frame_W_F1', 'frame_MACRO_F1', 'frame_CL_ACC',
           'video_W_F1_vote', 'video_W_F1_avg_probs',
           'video_W_F1_avg_logits']


def discover_runs(roots, include_unfinished=False):
    """Run dirs = dirs with config.yml + test-*-perf.pkl, gated on
    passed.txt like upstream (parseit.py:311-315)."""
    runs, skipped = [], []
    for root in roots:
        for cfg in sorted(glob.glob(join(root, '**', 'config.yml'),
                                    recursive=True)):
            d = os.path.dirname(cfg)
            if os.path.basename(os.path.dirname(d)) == 'best-models':
                continue  # per-best-model config copies, not run dirs
            if not glob.glob(join(d, f'{constants.TESTSET}-*-perf.pkl')):
                continue
            if not isfile(join(d, 'passed.txt')) and not include_unfinished:
                skipped.append(d)
                continue
            runs.append(d)
    return runs, skipped


def _item_from_filename(name):
    """'test-<item>-perf.pkl' -> item key as build_trackers produced it
    (str aggregation rule for MELD; 'None'/'7' ignore classes for
    C-EXPR-DB — keep the string form, it is only a grouping key)."""
    stem = name[len(f'{constants.TESTSET}-'):-len('-perf.pkl')]
    return stem


def extract_row(perf, dataset_name, item):
    """Scalar row (dict col->float|None) from one nested perf dict,
    matching compute_perf's layout perf[ignore][metric][level]."""
    # the ignore-class slice the item's master lives in
    ignore = None
    if dataset_name == constants.C_EXPR_DB and item == '7':
        ignore = 7
    sl = perf.get(ignore, {})

    def scalar(metric, level, video_pred=None):
        node = sl.get(metric, {}).get(level)
        if node is None:
            return None
        if video_pred is not None:
            node = node.get(video_pred)
            if node is None:
                return None
        v = node.get('master')
        return None if v is None else float(v)

    row = {
        'frame_W_F1': scalar(constants.W_F1, constants.FRAME_LEVEL),
        'frame_MACRO_F1': scalar(constants.MACRO_F1,
                                 constants.FRAME_LEVEL),
        'frame_CL_ACC': scalar(constants.CL_ACC, constants.FRAME_LEVEL),
        'video_W_F1_vote': scalar(constants.W_F1, constants.VIDEO_LEVEL,
                                  constants.FRM_VOTE),
        'video_W_F1_avg_probs': scalar(constants.W_F1,
                                       constants.VIDEO_LEVEL,
                                       constants.FRM_AVG_PROBS),
        'video_W_F1_avg_logits': scalar(constants.W_F1,
                                        constants.VIDEO_LEVEL,
                                        constants.FRM_AVG_LOGITS),
    }
    # master per build_trackers: MELD -> video W-F1 under the item's
    # aggregation; C-EXPR-DB* -> frame W-F1 (per ignore-class slice)
    if item in constants.VIDEO_PREDS:
        row['master'] = scalar(constants.W_F1, constants.VIDEO_LEVEL,
                               item)
    else:
        row['master'] = row['frame_W_F1']
    return row


def load_run(run_dir):
    cfg = flat_yaml.load(join(run_dir, 'config.yml')) or {}
    modality = cfg.get('modality')
    if isinstance(modality, (list, tuple)):
        modality = '+'.join(modality)
    meta = {'dir': run_dir,
            'dataset_name': cfg.get('dataset_name'),
            'model_name': cfg.get('model_name'),
            'modality': modality,
            'fold': cfg.get('fold_to_run'),
            'seed': cfg.get('seed')}
    items = {}
    for path in sorted(glob.glob(
            join(run_dir, f'{constants.TESTSET}-*-perf.pkl'))):
        item = _item_from_filename(os.path.basename(path))
        with open(path, 'rb') as f:
            perf = pickle.load(f)
        items[item] = extract_row(perf, meta['dataset_name'], item)
    return meta, items


def summarize(roots, include_unfinished=False):
    runs, skipped = discover_runs(roots, include_unfinished)
    rows = []          # one per (run, item)
    for d in runs:
        try:
            meta, items = load_run(d)
        except Exception as e:
            skipped.append(f'{d} (unreadable: {e})')
            continue
        for item, row in items.items():
            rows.append({**meta, 'item': item, **row})

    groups = {}
    for r in rows:
        key = (r['dataset_name'], r['model_name'], r['modality'],
               r['item'])
        groups.setdefault(key, []).append(r)

    summary = []
    for key in sorted(groups, key=str):
        grp = groups[key]
        agg = {'dataset_name': key[0], 'model_name': key[1],
               'modality': key[2], 'item': key[3], 'n_runs': len(grp),
               # key=str: a group can mix integer folds with fold=None
               # (config missing fold_to_run) — plain sorted() would
               # TypeError comparing them
               'folds': sorted({g['fold'] for g in grp}, key=str)}
        for col in COLUMNS:
            vals = [g[col] for g in grp if g[col] is not None]
            agg[f'{col}_mean'] = float(np.mean(vals)) if vals else None
            agg[f'{col}_std'] = float(np.std(vals)) if vals else None
        summary.append(agg)
    return {'runs': rows, 'groups': summary, 'skipped_unfinished': skipped}


def render(out):
    txt = []
    if out['runs']:
        header = ['run', 'fold', 'item'] + COLUMNS
        rows = []
        for r in sorted(out['runs'],
                        key=lambda r: (str(r['dataset_name']),
                                       str(r['item']), str(r['fold']))):
            rows.append([os.path.basename(r['dir'].rstrip('/')),
                         r['fold'], r['item']] +
                        [('-' if r[c] is None else r[c])
                         for c in COLUMNS])
        txt.append('Per-run test performance:')
        txt.append(draw_table(header, rows,
                              ['t', 't', 't'] + ['f'] * len(COLUMNS),
                              precision=4))
    if out['groups']:
        header = ['dataset', 'model', 'modality', 'item', 'n',
                  'master mean+/-std'] + \
                 [c for c in COLUMNS if c != 'master']
        rows = []
        for g in out['groups']:
            def ms(col):
                if g[f'{col}_mean'] is None:
                    return '-'
                return (f"{g[f'{col}_mean']:.4f}"
                        f"+/-{g[f'{col}_std']:.4f}")
            rows.append([g['dataset_name'], g['model_name'],
                         g['modality'], g['item'], g['n_runs'],
                         ms('master')] +
                        [ms(c) for c in COLUMNS if c != 'master'])
        txt.append('Aggregated over folds/seeds (mean +/- std):')
        txt.append(draw_table(header, rows, ['t'] * len(header)))
    if out['skipped_unfinished']:
        txt.append(f"Skipped {len(out['skipped_unfinished'])} "
                   f"unfinished run dir(s) (no passed.txt); "
                   f"--include_unfinished to include:")
        for d in out['skipped_unfinished']:
            txt.append(f'  {d}')
    if not out['runs']:
        txt.append('No completed runs found.')
    return '\n'.join(txt)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--roots', nargs='+', required=True,
                    help='experiment roots to scan recursively')
    ap.add_argument('--include_unfinished', action='store_true',
                    help='include run dirs without passed.txt')
    ap.add_argument('--json', default=None, help='write the summary here')
    args = ap.parse_args(argv)

    out = summarize(args.roots, args.include_unfinished)
    print(render(out))
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=2, sort_keys=True, default=str)
    return 0 if out['runs'] else 1


if __name__ == '__main__':
    sys.exit(main())
