"""The cells the tests drive, at full size or cut to one the CPU runs in
seconds (tests only).

Besides the cells of BENCHMARK.json, the tests drive the ResNet-18 cells
that are built but not in BENCHMARK.json (PERF.md, Open questions), on
its configuration (tests/resnet18-cls.json).  Their mixes, metric
entries and limits are the tests' own: the eval cell's limits were set
from card readings, the training cells' are thresholds the CPU's float32
runs are held to.  A cell moves into BENCHMARK.json with files of its
own under configs/, traffic/ and limits/ once its runs on the card are
proven.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path
from unittest import mock

from benchmark.harness import manifest

CONFIG = json.loads((Path(__file__).parent / "resnet18-cls.json").read_text())

_TRAIN = [{"name": "train_img_per_s", "unit": "img/s"}, {"name": "setup_s", "unit": "s"}]
_EVAL = [{"name": "eval_img_per_s", "unit": "img/s"}, {"name": "setup_s", "unit": "s"}]
_TRAIN_LAYERS = ["train_mfu", "bn_share.train", "capture_ms_per_epoch", "b1_roofline",
                 "device_idle.train"]
_UNITS = {"capture_ms_per_epoch": "ms", "h2d_ms_per_batch.eval": "ms"}
_TRAIN_LIMITS = {"loss_gap": 0.008, "grad_gap": 0.5, "change_gap": 0.12,
                 "change_median_gap": 0.007}

# name: (chips, traffic, end-to-end metrics, per-layer metrics, limits)
BUILT = {
    "resnet18-train-b128": (
        1, {"driver": "train_epochs", "batch_per_chip": 128, "scan_chunk": 4,
            "trace_seconds": 1},
        _TRAIN, _TRAIN_LAYERS, _TRAIN_LIMITS),
    "resnet18-eval": (
        1, {"driver": "eval_passes", "batch_per_chip": 64, "trace_seconds": 2},
        _EVAL, ["eval_mfu", "b2_roofline", "device_idle.eval", "h2d_ms_per_batch.eval"],
        {"logit_gap": 0.01, "logit_rms_ratio": 2.0}),
    "resnet18-train-dp4": (
        4, {"driver": "dp_train_epochs", "batch_per_chip": 16, "scan_chunk": 4,
            "trace_seconds": 1},
        _TRAIN, _TRAIN_LAYERS[:1] + _TRAIN_LAYERS[2:] + ["allreduce_share.dp"], _TRAIN_LIMITS),
}


def full(name: str) -> manifest.Cell:
    """A cell of BENCHMARK.json, or one of BUILT, at its own size."""
    if name not in BUILT:
        return manifest.cell(name)
    chips, traffic, e2e, layers, limits = BUILT[name]
    return manifest.Cell(name, chips, copy.deepcopy(CONFIG), dict(traffic), copy.deepcopy(e2e),
                         [{"name": n, "unit": _UNITS.get(n, "%")} for n in layers],
                         dict(limits))


def cell(name: str, size: int = 32, train_split: int = 26, test_split: int = 10,
         batch: int = 2, trace_seconds: float = 0.01) -> manifest.Cell:
    c = full(name)
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    cfg["architecture"]["image_size"] = size
    cfg["assumed"].update(train_split=train_split, test_split=test_split)
    tr.update(batch_per_chip=batch, trace_seconds=trace_seconds)
    return dataclasses.replace(c, config=cfg, traffic=tr)


def dp_cell(world: int = 2, **kw) -> manifest.Cell:
    """The four-card cell over `world` gloo ranks."""
    return dataclasses.replace(cell("resnet18-train-dp4", **kw), chips=world)


def card_branch():
    """The augmentation's card branch on CPU tensors (the kernels' plain
    versions), so the CPU runs the function the card runs."""
    return mock.patch("medseg_tpu_torch.ops.augment._on_card", lambda images: True)
