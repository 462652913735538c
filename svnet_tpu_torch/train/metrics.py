"""Classification metrics (counterpart of svnet_tpu/train/metrics.py):
accuracy and balanced accuracy with sklearn's semantics, in numpy."""

from __future__ import annotations

import numpy as np


def accuracy(y_true, y_pred) -> float:
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    return float((y_true == y_pred).mean())


def balanced_accuracy(y_true, y_pred) -> float:
    """Mean of the per-class recalls over the classes present in y_true."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    return float(np.mean([(y_pred[y_true == c] == c).mean()
                          for c in np.unique(y_true)]))
