"""Classification and part-segmentation metrics (counterpart of
svnet_tpu/train/metrics.py): accuracy and balanced accuracy with
sklearn's semantics, and the per-shape mean part IoU, in numpy."""

from __future__ import annotations

import numpy as np

# ShapeNet part's 16 categories: parts per category and the first part's id
SEG_NUM = [4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3]
INDEX_START = [0, 4, 6, 8, 12, 16, 19, 22, 24, 28, 30, 36, 38, 41, 44, 47]


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


def shape_iou(pred, seg, label, class_choice=None) -> list:
    """Per-shape mean part IoU over the parts of the shape's category (with
    ``class_choice``, over parts 0..SEG_NUM[label[0]) - 1, the dataset's
    one category); a part absent from both prediction and truth counts as
    IoU 1. pred, seg (shapes, N) part ids; label (shapes,) categories."""
    pred, seg = np.asarray(pred), np.asarray(seg)
    label = np.asarray(label).reshape(-1)
    ious = []
    for i in range(seg.shape[0]):
        if class_choice:
            parts = range(SEG_NUM[label[0]])
        else:
            start = INDEX_START[label[i]]
            parts = range(start, start + SEG_NUM[label[i]])
        part_ious = []
        for part in parts:
            p, s = pred[i] == part, seg[i] == part
            union = np.sum(p | s)
            part_ious.append(1.0 if union == 0 else np.sum(p & s) / union)
        ious.append(float(np.mean(part_ious)))
    return ious
