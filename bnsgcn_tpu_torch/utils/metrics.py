"""Accuracy, micro-F1 and the train-row feature scaler (counterpart of
bnsgcn_tpu/utils/metrics.py; host numpy, sklearn-free)."""

from __future__ import annotations

import numpy as np


def micro_f1(labels: np.ndarray, preds: np.ndarray) -> float:
    """Micro-averaged F1 over a multi-hot label matrix; preds boolean."""
    labels = np.asarray(labels).astype(bool)
    preds = np.asarray(preds).astype(bool)
    tp = np.sum(labels & preds)
    fp = np.sum(~labels & preds)
    fn = np.sum(labels & ~preds)
    denom = 2 * tp + fp + fn
    return float(2 * tp / denom) if denom > 0 else 0.0


def calc_acc(logits: np.ndarray, labels: np.ndarray) -> float:
    """argmax accuracy for single-label rows, micro-F1 of (logits > 0) for
    multi-label rows (reference train.py:13-19)."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    if labels.ndim == 1:
        return float(np.mean(np.argmax(logits, axis=1) == labels))
    return micro_f1(labels, logits > 0)


def standard_scale(feat: np.ndarray, fit_mask: np.ndarray) -> np.ndarray:
    """StandardScaler fitted on the train rows (reference
    helper/utils.py:54-57)."""
    mu = feat[fit_mask].mean(axis=0)
    sd = feat[fit_mask].std(axis=0)
    sd = np.where(sd < 1e-12, 1.0, sd)
    return ((feat - mu) / sd).astype(np.float32)
