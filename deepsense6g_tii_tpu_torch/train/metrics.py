"""Beam-prediction metrics in numpy (own copy of
``deepsense6g_tii_tpu/train/metrics.py:19-65``): top-k accuracy, the
distance-based accuracy (DBA) score and the multi-step flatten."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def compute_acc(y_pred, y_true, top_k: Sequence[int] = (1, 2, 3)):
    """Top-k hit rates in percent, rounded to 4 decimals; y_pred (N, beams)
    indices by descending score, y_true (N,)."""
    y_pred, y_true = np.asarray(y_pred), np.asarray(y_true)
    if len(y_pred) != len(y_true):
        raise ValueError("Number of predicted beams does not match number "
                         "of labels.")
    hits = y_pred[:, : max(top_k)] == y_true[:, None]
    return np.round(
        np.array([hits[:, :k].any(axis=1).mean() for k in top_k]) * 100, 4)


def compute_dba_score(y_pred, y_true, max_k: int = 3,
                      delta: float = 5.0) -> float:
    """Mean over k <= max_k of 1 - mean_i min_{j<=k} min(|pred_ij -
    true_i| / delta, 1)."""
    y_pred = np.asarray(y_pred, dtype=np.float64)
    y_true = np.asarray(y_true, dtype=np.float64)
    dist = np.minimum(np.abs(y_pred[:, :max_k] - y_true[:, None]) / delta,
                      1.0)
    run_min = np.minimum.accumulate(dist, axis=1)
    return float((1.0 - run_min.mean(axis=0)).mean())


def flatten_multistep(y_pred, y_true):
    """(N, pred_len, beams) rankings and (N, pred_len) labels -> 2-D/1-D."""
    n, p, b = y_pred.shape
    return y_pred.reshape(n * p, b), np.asarray(y_true).reshape(n * p)
