"""The regression trainer's artifacts (``fvt_tpu/train/regression_viz.py``):

  * per-trial output-vs-continuous-label plots,
    ``plot/{train|validate|test}/epoch_<e>/<trial>.jpg`` (upstream
    ``base/logger.py``'s ``PlotHandler``); matplotlib is imported inside
    the plot function, so the rest runs where it is absent;
  * a per-epoch CSV of losses and rmse/pcc/ccc, ``training_logs.csv``
    (upstream ``base/checkpointer.py``), with the final test row.

Plain functions over ``compute_regression_perf``'s {'rmse', 'pcc', 'ccc'}
dicts and the per-video {'labels', 'preds'} map.
"""
from __future__ import annotations

import csv
import os
import time
from os.path import join
from typing import Dict, Optional

import numpy as np

CSV_COLUMNS = ['time', 'epoch', 'best_epoch', 'lr',
               'tr_loss', 'val_loss', 'tr_rmse', 'tr_pcc', 'tr_ccc',
               'val_rmse', 'val_pcc', 'val_ccc']


def plot_dir(outd: str, train_mode: Optional[bool], epoch) -> str:
    """Reference directory rule (base/logger.py:160-177): train/validate
    per epoch; ``epoch=None`` means the final test pass."""
    if epoch is None:
        sub = 'test'
        d = join(outd, 'plot', sub)
    else:
        sub = 'train' if train_mode else 'validate'
        d = join(outd, 'plot', sub, f'epoch_{epoch}')
    os.makedirs(d, exist_ok=True)
    return d


def save_output_vs_label_plots(per_video: Dict[str, dict], perf: dict,
                               outd: str, epoch=None,
                               train_mode: Optional[bool] = None) -> str:
    """One jpg per trial: predicted continuous output over the label
    curve, titled with the epoch metrics (PlotHandler
    save_output_vs_continuous_label_plot / plot_and_save)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    d = plot_dir(outd, train_mode, epoch)
    title = ' '.join(f"{k}={perf[k]:.3f}" for k in ('rmse', 'pcc', 'ccc')
                     if k in perf)
    for trial, rec in per_video.items():
        fig, ax = plt.subplots(1, 1)
        ax.plot(np.asarray(rec['labels']).reshape(-1), label='label')
        ax.plot(np.asarray(rec['preds']).reshape(-1), label='output')
        ax.legend()
        ax.set_title(f'{trial}  {title}')
        fig.savefig(join(d, f'{trial}.jpg'))
        plt.close(fig)
    return d


def init_epoch_csv(outd: str) -> str:
    path = join(outd, 'training_logs.csv')
    with open(path, 'w', newline='') as f:
        csv.writer(f).writerow(CSV_COLUMNS)
    return path


def append_epoch_csv(outd: str, epoch: int, best_epoch: int, lr: float,
                     tr_loss: float, val_loss: float,
                     train_perf: dict, valid_perf: dict) -> str:
    """One row per epoch (checkpointer.save_log_to_csv semantics; the
    reference's pcc confidence column is dropped — scipy's p-value was
    logged but never consumed)."""
    path = join(outd, 'training_logs.csv')
    if not os.path.isfile(path):
        init_epoch_csv(outd)
    with open(path, 'a', newline='') as f:
        csv.writer(f).writerow([
            time.time(), epoch, best_epoch, lr, tr_loss, val_loss,
            train_perf['rmse'], train_perf['pcc'], train_perf['ccc'],
            valid_perf['rmse'], valid_perf['pcc'], valid_perf['ccc']])
    return path


def append_test_csv(outd: str, test_perf: dict) -> str:
    """Final test row (checkpointer.py:62-65)."""
    path = join(outd, 'training_logs.csv')
    with open(path, 'a', newline='') as f:
        csv.writer(f).writerow(
            ['Test results:', 'rmse:', test_perf['rmse'],
             'pcc:', test_perf['pcc'], 'ccc:', test_perf['ccc']])
    return path
