"""Accuracy metric (counterpart of bnsgcn_tpu/utils/metrics.py; host numpy)."""

from __future__ import annotations

import numpy as np


def calc_acc(logits: np.ndarray, labels: np.ndarray) -> float:
    """argmax accuracy over single-label rows (reference train.py:13-19)."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    if labels.ndim != 1:
        raise ValueError("multi-label accuracy (micro-F1) is not ported yet")
    return float(np.mean(np.argmax(logits, axis=1) == labels))
