"""Result CSV export in the reference's exact schema.

Counterpart of medseg_tpu/eval/csv_io.py (reference utils/tester.py:808-876):
classification rows drop the confusion matrix and per-class vectors; column
order follows metric-dict insertion (Model, accuracy, precision, recall, f1
/ Model, iou, dice, pixel_accuracy, precision, recall, f1).  The port writes
with the standard library's `csv` module, and for the metric dicts the
harness returns (float values) its files are byte for byte what the JAX
package writes through pandas' `to_csv(index=False)`: columns in order of
first appearance, `\\n` line ends, minimal quoting, floats as their
shortest repr and missing cells empty.
"""

from __future__ import annotations

import csv
import os
from typing import Callable, Dict, List

_CLS_DROP = ("confusion_matrix", "precision_per_class", "recall_per_class",
             "f1_per_class")


def _cell(v) -> str:
    """pandas' text for a cell: the shortest repr of a float (numpy's
    float64 is a float), str() of anything else."""
    return repr(float(v)) if isinstance(v, float) else str(v)


def _write_rows(path: str, rows: List[Dict]):
    columns: List[str] = []
    for row in rows:
        columns.extend(k for k in row if k not in columns)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows([_cell(row[k]) if k in row else "" for k in columns]
                         for row in rows)


def save_results_to_csv(
    results: Dict[str, Dict],
    cls_output_path: str = "results/classification_test_results.csv",
    seg_output_path: str = "results/segmentation_test_results.csv",
    log: Callable[[str], None] = print,
):
    if not results:
        log("\n[INFO] No results to save.")
        return
    cls_models = [k for k in results
                  if any(x in k for x in ("ResNet18", "ResNet50", "VGG", "CLIP"))
                  and "Seg" not in k]
    seg_models = [k for k in results
                  if "Unet" in k or "UNet" in k or "CLIPSeg" in k]

    if cls_models:
        rows = []
        for name in cls_models:
            row = {"Model": name}
            row.update({k: v for k, v in results[name].items()
                        if k not in _CLS_DROP})
            rows.append(row)
        _write_rows(cls_output_path, rows)
        log(f"\n[INFO] Classification results saved to: {cls_output_path}")
    else:
        log("\n[INFO] No classification results to save.")

    if seg_models:
        rows = []
        for name in seg_models:
            row = {"Model": name}
            row.update(results[name])
            rows.append(row)
        _write_rows(seg_output_path, rows)
        log(f"[INFO] Segmentation results saved to: {seg_output_path}")
    else:
        log("\n[INFO] No segmentation results to save.")
