"""The regression task's losses and score (``fvt_tpu/train/losses.py``).

:func:`ccc_loss` is the training loss of the upstream legacy
valence/arousal trainer (``base/loss_function.py``): Lin's concordance per
sequence with unbiased variances, ``1 - CCC`` averaged.  As there, the
numerator is the elementwise product of the centred sequences, not its
mean, so ``ccc`` is (B, T) and the loss averages over all B*T elements.
:func:`ccc_score` is the evaluation metric (``base/logger.py``'s
ContinuousMetricsCalculator): float64 numpy, a ddof-0 covariance over
ddof-1 variances, so identical arrays score (n-1)/n.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def ccc(gold: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Per-sequence CCC over axis 1 of gold and pred (B, T): (B, T)."""
    gold_mean = gold.mean(dim=1, keepdim=True)
    pred_mean = pred.mean(dim=1, keepdim=True)
    covariance = (gold - gold_mean) * (pred - pred_mean)
    gold_var = gold.var(dim=1, keepdim=True, correction=1)
    pred_var = pred.var(dim=1, keepdim=True, correction=1)
    return 2.0 * covariance / (
        gold_var + pred_var + (gold_mean - pred_mean).square() + 1e-50)


def ccc_loss(gold: torch.Tensor, pred: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean(1 - CCC), the elementwise ``weights`` applied before the
    mean."""
    loss = 1.0 - ccc(gold, pred)
    if weights is not None:
        loss = loss * weights
    return loss.mean()


def ccc_score(gold, pred) -> float:
    """Lin's CCC over the flattened arrays, the evaluation metric."""
    g = np.asarray(gold, dtype=np.float64).ravel()
    p = np.asarray(pred, dtype=np.float64).ravel()
    gm, pm = g.mean(), p.mean()
    gv = ((g - gm) ** 2).sum() / (len(g) - 1)
    pv = ((p - pm) ** 2).sum() / (len(p) - 1)
    cov = ((g - gm) * (p - pm)).mean()
    return float(2 * cov / (gv + pv + (gm - pm) ** 2 + 1e-100))
