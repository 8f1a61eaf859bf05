"""Classification metrics reproducing the reference formulas exactly.

A numpy copy of medseg_tpu/eval/metrics.py:33-81 (reference
utils/tester.py:49-88): accuracy and weighted precision/recall/F1 with
sklearn's zero_division=0 semantics, per-class values and the confusion
matrix, all x100.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def confusion_matrix(labels, preds, num_classes: int) -> np.ndarray:
    """Rows = true class, cols = predicted class (sklearn convention)."""
    labels = np.asarray(labels).astype(np.int64)
    preds = np.asarray(preds).astype(np.int64)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (labels, preds), 1)
    return cm


def _safe_div(num, den):
    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64)
    out = np.zeros_like(num)
    np.divide(num, den, out=out, where=den != 0)
    return out


def classification_metrics(preds, labels, num_classes: int = 3) -> Dict:
    """Accuracy, weighted/per-class precision-recall-F1, confusion matrix; x100.

    preds/labels: integer arrays (numpy, or CPU tensors numpy can read).
    """
    cm = confusion_matrix(labels, preds, num_classes)
    support = cm.sum(axis=1)  # true count per class
    predicted = cm.sum(axis=0)  # predicted count per class
    tp = np.diag(cm).astype(np.float64)
    total = cm.sum()

    precision_c = _safe_div(tp, predicted)
    recall_c = _safe_div(tp, support)
    f1_c = _safe_div(2 * precision_c * recall_c, precision_c + recall_c)

    weights = _safe_div(support, total)
    accuracy = _safe_div(tp.sum(), total)
    precision = float((precision_c * weights).sum())
    recall = float((recall_c * weights).sum())
    f1 = float((f1_c * weights).sum())

    return {
        "accuracy": float(accuracy) * 100.0,
        "precision": precision * 100.0,
        "recall": recall * 100.0,
        "f1": f1 * 100.0,
        "precision_per_class": precision_c * 100.0,
        "recall_per_class": recall_c * 100.0,
        "f1_per_class": f1_c * 100.0,
        "confusion_matrix": cm,
    }
