"""ROC curve and ROC-AUC of a binary classifier in numpy.

The ext runner of the JAX package scores its filter with
``sklearn.metrics`` (hnd_ghnd_tpu/runners/ext_runner.py:143, :163), which
the GPU host is not promised.  These are the semantics of scikit-learn 1.9's
``roc_curve`` and ``roc_auc_score`` for binary labels without sample
weights: scores sorted descending (stable), tied scores collapsed into one
threshold, collinear points dropped (``drop_intermediate``), a leading
threshold of ``inf`` at (0, 0); NaN rates with a warning when a class is
missing, and a NaN ROC-AUC with a warning when ``y_true`` holds one class.
"""
from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np


class UndefinedMetricWarning(UserWarning):
    """A rate or score is undefined for the labels given."""


def _clf_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(false positives, true positives, thresholds) at each distinct score,
    from the highest down."""
    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score).reshape(-1)
    if y_true.shape != y_score.shape:
        raise ValueError(f"y_true {y_true.shape} and y_score {y_score.shape} "
                         "differ in length")
    if y_true.size == 0:
        raise ValueError("no samples")
    if not np.isfinite(y_score).all():
        raise ValueError("y_score holds NaN or infinity")
    classes = np.unique(y_true)
    if not np.isin(classes, (0, 1)).all():
        raise ValueError(f"binary labels 0 and 1 expected, got {classes}")
    order = np.argsort(-y_score, kind="stable")
    y_score = y_score[order]
    y_true = (y_true[order] == 1).astype(np.float64)
    distinct = np.nonzero(np.diff(y_score))[0]
    idx = np.concatenate([distinct, [y_true.size - 1]])
    tps = np.cumsum(y_true)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score, drop_intermediate: bool = True):
    """(fpr, tpr, thresholds) as ``sklearn.metrics.roc_curve``."""
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    if drop_intermediate and fps.shape[0] > 2:
        keep = np.nonzero(np.concatenate([
            [True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
            [True]]))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    if fps[-1] <= 0:
        warnings.warn("No negative samples in y_true, false positive value "
                      "should be meaningless", UndefinedMetricWarning)
        fpr = np.full(fps.shape, np.nan)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn("No positive samples in y_true, true positive value "
                      "should be meaningless", UndefinedMetricWarning)
        tpr = np.full(tps.shape, np.nan)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def roc_auc_score(y_true, y_score) -> float:
    """The area under ``roc_curve`` (trapezoids), as
    ``sklearn.metrics.roc_auc_score`` of binary labels; NaN, with a
    warning, when ``y_true`` holds one class."""
    if len(np.unique(np.asarray(y_true))) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is "
                      "not defined in that case.", UndefinedMetricWarning)
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    # numpy's trapezoid rule, spelled out (np.trapezoid is numpy >= 2)
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())
