"""Batched offline inference: the cascade over a directory of images.

Counterpart of medseg_tpu/infer/batch.py:36-162 (`medseg predict`): each
original decodes once (cv2, else PIL, as the JAX package's
data/packed.py:32-43) and is resized straight to each
model's serving grid (Pipeline.input_grid and Pipeline._to_grid, so
`predict` is pixel-consistent with `serve`); every batch runs one
classification forward (B2's eval form, with CLIP's constants for CLIP, +
the classifier, softmax on the device, read once) and, if any prediction
is COVID, one segmentation forward over the whole batch (read once);
overlays are rendered and written only for COVID predictions.  CLIP's
prompt features and CLIPSeg's conditional embedding come from their
checkpoints' text towers (eval/harness.load_model_bundle).

Outputs: predictions.csv (file, prediction, confidence, overlay_path) and
<name>_overlay.png per COVID case.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from medseg_tpu_torch.core.config import CLASSES, EvalConfig
from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.eval.harness import load_model_bundle
from medseg_tpu_torch.infer.overlay import red_overlay
from medseg_tpu_torch.infer.pipeline import Pipeline, model_forward


def batch_predict(
    image_paths: List[str],
    cls_name: str = "ResNet18",
    seg_name: str = "ResNetUnet",
    cfg: EvalConfig = EvalConfig(),
    batch_size: int = 64,
    overlay_opacity: float = 0.5,
    output_dir: Optional[str] = None,
    log: Callable[[str], None] = print,
    device: DeviceLike = None,
):
    """Returns a list of dicts {file, prediction, confidence, overlay_path}.
    device: the card unless "cpu" is passed; without a card it raises."""
    device = resolve_device(device)
    cls_bundle = load_model_bundle(cls_name, cfg.weights_root, False, device)
    if cls_bundle is None:
        raise FileNotFoundError(f"no weights for {cls_name} under "
                                f"{cfg.weights_root}")
    cls_fn = model_forward(cls_name, *cls_bundle, False, device)
    seg_bundle = load_model_bundle(seg_name, cfg.weights_root, True, device)
    if seg_bundle is None:
        log(f"[WARNING] no weights for {seg_name}; segmentation skipped")
        seg_fn = None
    else:
        seg_fn = model_forward(seg_name, *seg_bundle, True, device)
    cls_grid = Pipeline.input_grid(cls_name)
    seg_grid = Pipeline.input_grid(seg_name)

    out_dir = Path(output_dir) if output_dir else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
    results = []

    for start in range(0, len(image_paths), batch_size):
        chunk = image_paths[start:start + batch_size]
        originals = [_decode_rgb(Path(p)) for p in chunk]

        cls_in = Pipeline._grid_batch(originals, cls_grid[0], device, cls_grid[1])
        with torch.inference_mode():
            probs_cls = torch.softmax(cls_fn(cls_in).to(torch.float32), dim=-1)
        probs_cls = probs_cls.cpu().numpy()
        preds = probs_cls.argmax(axis=-1)
        confs = probs_cls.max(axis=-1) * 100.0

        probs = None
        if seg_fn is not None and np.any(preds == CLASSES.index("COVID")):
            seg_in = (cls_in if seg_grid == cls_grid
                      else Pipeline._grid_batch(originals, seg_grid[0], device, seg_grid[1]))
            probs = seg_fn(seg_in)[..., 0].cpu().numpy()

        for i, path in enumerate(chunk):
            pred = CLASSES[int(preds[i])]
            rec = {"file": Path(path).name, "prediction": pred,
                   "confidence": float(confs[i]), "overlay_path": None}
            if pred == "COVID" and probs is not None and out_dir:
                mask = (probs[i] > cfg.threshold).astype(np.uint8) * 255
                overlay = red_overlay(originals[i], mask, overlay_opacity)
                op = out_dir / f"{Path(path).stem}_overlay.png"
                _write_png(overlay, op)
                rec["overlay_path"] = str(op)
            results.append(rec)
        log(f"[predict] {min(start + batch_size, len(image_paths))}/"
            f"{len(image_paths)}")

    if out_dir:
        csv_path = out_dir / "predictions.csv"
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["file", "prediction",
                                              "confidence", "overlay_path"])
            w.writeheader()
            w.writerows(results)
        log(f"[predict] wrote {csv_path}")
    return results


def _decode_rgb(path: Path) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_COLOR)  # BGR
        if img is None:
            raise IOError(path)
        return img[:, :, ::-1]
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))


def _write_png(arr: np.ndarray, path: Path):
    try:
        import cv2

        cv2.imwrite(str(path), arr[:, :, ::-1])
    except ImportError:
        from PIL import Image

        Image.fromarray(arr).save(path)
