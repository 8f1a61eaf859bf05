"""Evaluation harness: test every model on the held-out split.

Counterpart of medseg_tpu/eval/harness.py (reference utils/tester.py:197-805):
each batch is preprocessed on the card by one launch of the photometric
kernel (ops/augment.preprocess_eval_batch; a segmentation mask's /255 is
plain torch ops, as in the JAX package) and run through the model.  A
classifier's argmax predictions, or a segmentation model's per-sample
metric vectors (sigmoid, threshold, eval/metrics.py), stay on the device
until the split ends and are read once; `classification_metrics` or
`average_segmentation_metrics` then computes the reference's figures.  Log
lines, the summary tables and skip-on-missing-weights follow the JAX
package word for word.

Differences from the JAX package:
- weights come only from the reference's torch `.pt` state dicts
  (`{weights_root}/classification_models/{name}_best_acc.pt`,
  `{weights_root}/segmentation_models/{name}_best_loss.pt`), which load
  into the port's models, named as the reference's, with strict=True; the
  port's trainer writes the same files (train/checkpoint.py);
- models the port lacks raise NotImplementedError naming their ROADMAP
  item (PENDING_CLS_MODELS, PENDING_SEG_MODELS), as does the mesh branch
  (ROADMAP A.14); CLIPSeg's branch comes with it (A.12);
- no retry: `_evaluate_with_retry` guarded against a relay the card does not
  use, so test_all_models calls evaluate_model directly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from medseg_tpu_torch.core.config import CLASSES, EvalConfig
from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.registry import get_model
from medseg_tpu_torch.data.loader import BatchLoader
from medseg_tpu_torch.eval import metrics as M
from medseg_tpu_torch.ops.augment import preprocess_eval_batch

CLS_MODELS = ("ResNet18", "ResNet50", "VGG16", "VGG19", "CLIP")
SEG_MODELS = ("ResNetUnet", "AttentionUNet", "R2Unet", "R2AttUnet", "CLIPSeg")
_SEG_NAMES = {m.lower() for m in SEG_MODELS}
# models the port lacks yet, by the ROADMAP item that brings them
PENDING_CLS_MODELS = {"clip": "A.12"}
PENDING_SEG_MODELS = {"clipseg": "A.12"}


def refuse_pending(name: str, what: str) -> None:
    """NotImplementedError for a model the port lacks yet, naming its item."""
    for task, pending in (("classification", PENDING_CLS_MODELS),
                          ("segmentation", PENDING_SEG_MODELS)):
        item = pending.get(name.lower())
        if item is not None:
            raise NotImplementedError(f"{what} {name} ({task}) waits for its "
                                      f"port (ROADMAP {item})")


def load_model_bundle(name: str, weights_root: str,
                      seg: bool) -> Optional[Dict[str, torch.Tensor]]:
    """The reference's torch state dict for `name`, or None when it is
    missing.  The port's bundle is the state dict alone: the CLIP models'
    extra inputs wait for ROADMAP A.12."""
    sub = "segmentation_models" if seg else "classification_models"
    suffix = "best_loss" if seg else "best_acc"
    pt_path = Path(weights_root) / sub / f"{name}_{suffix}.pt"
    if not pt_path.exists():
        return None
    return torch.load(str(pt_path), map_location="cpu", weights_only=True)


def _eval_classification(model, loader: BatchLoader, device: torch.device):
    preds, labels = [], []
    with torch.inference_mode():
        for (images, targets), n_real in zip(loader, loader.real_counts()):
            x, _ = preprocess_eval_batch(images.to(device))
            p = model(x).argmax(-1)
            preds.append(p[:n_real])  # trim pad_to_multiple padding
            labels.append(targets[:n_real])
    # one fetch for the whole split: a per-batch fetch would wait on the card
    return M.classification_metrics(torch.cat(preds).cpu().numpy(),
                                    torch.cat(labels).cpu().numpy(),
                                    num_classes=len(CLASSES))


def _log_classification(name: str, res: Dict, log: Callable[[str], None]):
    log(f"\n{name} Test Results:")
    log("-" * 60)
    log(f"Accuracy:  {res['accuracy']:.2f}%")
    log(f"Precision: {res['precision']:.2f}%")
    log(f"Recall:    {res['recall']:.2f}%")
    log(f"F1 Score:  {res['f1']:.2f}%")
    log("\nPer-Class Metrics:")
    for i, cls in enumerate(CLASSES):
        log(f"\n{cls}:")
        log(f"  Precision: {res['precision_per_class'][i]:.2f}%")
        log(f"  Recall:    {res['recall_per_class'][i]:.2f}%")
        log(f"  F1 Score:  {res['f1_per_class'][i]:.2f}%")
    log("\nConfusion Matrix:")
    log("".join(f"{c:>12}" for c in CLASSES))
    for i, row in enumerate(res["confusion_matrix"]):
        log(f"{CLASSES[i]:<12}" + "".join(f"{val:>12}" for val in row))


def _eval_segmentation(model, loader: BatchLoader, device: torch.device,
                       threshold: float):
    acc: Dict[str, list] = {}
    with torch.inference_mode():
        for (images, masks), n_real in zip(loader, loader.real_counts()):
            x, m = preprocess_eval_batch(images.to(device), masks.to(device))
            probs = torch.sigmoid(model(x).to(torch.float32))
            for k, v in M.segmentation_metrics_batched(probs, m, threshold).items():
                acc.setdefault(k, []).append(v[:n_real])  # trim padding
    # one fetch for the whole split (see _eval_classification)
    per_sample = torch.stack([torch.cat(v) for v in acc.values()]).cpu().numpy()
    return M.average_segmentation_metrics(dict(zip(acc, per_sample)))


def _log_segmentation(name: str, res: Dict, log: Callable[[str], None]):
    log(f"\n{name} Test Results:")
    log("-" * 60)
    log(f"IoU (Jaccard):     {res['iou']:.2f}%")
    log(f"Dice Coefficient:  {res['dice']:.2f}%")
    log(f"Pixel Accuracy:    {res['pixel_accuracy']:.2f}%")
    log(f"Precision:         {res['precision']:.2f}%")
    log(f"Recall:            {res['recall']:.2f}%")
    log(f"F1 Score:          {res['f1']:.2f}%")


def evaluate_model(name: str, loader: BatchLoader,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None,
                   cfg: EvalConfig = EvalConfig(), *,
                   log: Callable[[str], None] = print, mesh=None,
                   device: DeviceLike = None) -> Optional[Dict]:
    """Evaluate one model; loads its weights if `state_dict` is None and
    returns None (after a warning) when they are missing.

    The model is built in the factory's default dtype (float32) on `device`
    (the card unless device="cpu"), and each batch is moved there."""
    device = resolve_device(device)
    seg = name.lower() in _SEG_NAMES
    if state_dict is None:
        state_dict = load_model_bundle(name, cfg.weights_root, seg)
        if state_dict is None:
            log(f"\n[WARNING] Weights not found for {name}")
            log(f"Skipping {name}...")
            return None
    if mesh is not None:
        raise NotImplementedError("sharded eval waits for the data-parallel "
                                  "port (ROADMAP A.14)")
    refuse_pending(name, "evaluating")
    model = get_model(name)["factory"](device=device)
    model.load_state_dict(state_dict, strict=True)
    model.eval()
    log(f"\n{'=' * 60}")
    log(f"Testing {'Segmentation' if seg else 'Classification'} Model: {name}")
    log(f"{'=' * 60}")
    if seg:
        res = _eval_segmentation(model, loader, device, cfg.threshold)
        _log_segmentation(name, res, log)
    else:
        res = _eval_classification(model, loader, device)
        _log_classification(name, res, log)
    log("=" * 60 + "\n")
    return res


def test_all_models(cls_loader: Optional[BatchLoader],
                    seg_loader: Optional[BatchLoader],
                    cfg: EvalConfig = EvalConfig(), *,
                    log: Callable[[str], None] = print, mesh=None,
                    device: DeviceLike = None) -> Dict[str, Dict]:
    """Evaluate the whole zoo (tester.py:513-735): models without weights are
    skipped, and a model that fails is logged and skipped; returns
    {model: metrics}.  Without a card it raises before the first model
    unless device="cpu"."""
    device = resolve_device(device)
    results: Dict[str, Dict] = {}

    def run_family(loader, names):
        for name in names:
            try:
                res = evaluate_model(name, loader, None, cfg, log=log,
                                     mesh=mesh, device=device)
                if res is not None:
                    results[name] = res
            except Exception as e:  # graceful skip (tester.py:630-635)
                log(f"\n[ERROR] Failed to test {name} (error): {e}")

    if cls_loader is not None:
        log(f"\n[INFO] Classification Test Dataset: {cls_loader.num_samples} samples")
        run_family(cls_loader, CLS_MODELS)
    if seg_loader is not None:
        log(f"\n[INFO] Segmentation Test Dataset: {seg_loader.num_samples} samples")
        run_family(seg_loader, SEG_MODELS)
    return results


def print_summary(results: Dict[str, Dict], log: Callable[[str], None] = print):
    """Reference summary tables with best-model callouts (tester.py:738-805)."""
    if not results:
        log("\n[INFO] No test results to display.")
        return
    log("\n" + "=" * 80)
    log(" " * 25 + "TEST RESULTS SUMMARY")
    log("=" * 80)

    cls_models = [m for m in CLS_MODELS if m in results]
    if cls_models:
        log("\nCLASSIFICATION MODELS:")
        log("-" * 80)
        log(f"{'Model':<20} {'Accuracy':<12} {'Precision':<12} {'Recall':<12} "
            f"{'F1 Score':<12}")
        log("-" * 80)
        for m in cls_models:
            r = results[m]
            log(f"{m:<20} {r['accuracy']:>10.2f}% {r['precision']:>10.2f}% "
                f"{r['recall']:>10.2f}% {r['f1']:>10.2f}%")
        best = max(cls_models, key=lambda m: results[m]["accuracy"])
        log(f"\nBest Classification Model: {best} "
            f"(Accuracy: {results[best]['accuracy']:.2f}%)")

    seg_models = [m for m in SEG_MODELS if m in results]
    if seg_models:
        log("\n\nSEGMENTATION MODELS:")
        log("-" * 80)
        log(f"{'Model':<20} {'IoU':<10} {'Dice':<10} {'Precision':<12} "
            f"{'Recall':<12} {'F1 Score':<12}")
        log("-" * 80)
        for m in seg_models:
            r = results[m]
            log(f"{m:<20} {r['iou']:>8.2f}% {r['dice']:>8.2f}% "
                f"{r['precision']:>10.2f}% {r['recall']:>10.2f}% "
                f"{r['f1']:>10.2f}%")
        best = max(seg_models, key=lambda m: results[m]["dice"])
        log(f"\nBest Segmentation Model: {best} "
            f"(Dice: {results[best]['dice']:.2f}%)")
    log("=" * 80 + "\n")
