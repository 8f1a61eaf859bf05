"""Metrics reproducing the reference formulas exactly, all x100.

- Classification: a numpy copy of medseg_tpu/eval/metrics.py:33-81
  (reference utils/tester.py:49-88): accuracy and weighted
  precision/recall/F1 with sklearn's zero_division=0 semantics, per-class
  values and the confusion matrix.
- Segmentation: per-sample IoU, Dice, pixel accuracy, precision, recall and
  F1 of a batch as float32 tensors on the batch's device
  (medseg_tpu/eval/metrics.py:126-162, reference utils/tester.py:281-289),
  and their mean over the split in float64 (:165-174).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


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


EPS = 1e-7


def segmentation_metrics_batched(pred: torch.Tensor, target: torch.Tensor,
                                 threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """Per-sample metrics of a batch, each a [B] float32 tensor (x100):
    pred and target thresholded at `threshold`, reduced over every axis
    but the batch's."""
    b = pred.shape[0]
    p = (pred.reshape(b, -1).to(torch.float32) > threshold).to(torch.float32)
    t = (target.reshape(b, -1).to(torch.float32) > threshold).to(torch.float32)
    inter = (p * t).sum(1)
    union = ((p + t) > 0).to(torch.float32).sum(1)
    psum, tsum = p.sum(1), t.sum(1)

    iou = (inter + EPS) / (union + EPS)
    dice = (2.0 * inter + EPS) / (psum + tsum + EPS)
    pixel_acc = (p == t).to(torch.float32).sum(1) / p.shape[1]

    tp = inter
    fp = (p * (1.0 - t)).sum(1)
    fn = ((1.0 - p) * t).sum(1)
    precision = (tp + EPS) / (tp + fp + EPS)
    recall = (tp + EPS) / (tp + fn + EPS)
    f1 = 2.0 * (precision * recall) / (precision + recall + EPS)
    return {"iou": iou * 100.0, "dice": dice * 100.0,
            "pixel_accuracy": pixel_acc * 100.0, "precision": precision * 100.0,
            "recall": recall * 100.0, "f1": f1 * 100.0}


def average_segmentation_metrics(per_sample: Dict[str, np.ndarray],
                                 valid_mask=None) -> Dict[str, float]:
    """Mean over samples in float64, leaving out the rows where
    `valid_mask` is False (padding)."""
    out = {}
    for k, v in per_sample.items():
        v = np.asarray(v, dtype=np.float64)
        if valid_mask is not None:
            v = v[np.asarray(valid_mask, dtype=bool)]
        out[k] = float(v.mean())
    return out
