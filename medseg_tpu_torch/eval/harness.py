"""Evaluation harness: test every model on the held-out split.

Counterpart of medseg_tpu/eval/harness.py (reference utils/tester.py:197-805):
each batch is preprocessed on the card and run through the model.  The CNNs'
batches are one launch of the photometric kernel each
(ops/augment.preprocess_eval_batch); CLIP's and CLIPSeg's are
ops/clip_prep.clip_preprocess from the packed 256 batch, a bicubic resize
to 224 or 352 in float32 and CLIP's normalization, plain torch operations
with no kernel, as the JAX package leaves them to XLA.  A segmentation
mask's /255 is plain torch operations, as in the JAX package.  CLIPSeg's
probabilities (sigmoid on its 352 grid) are resized bilinearly to the
mask's grid as jax.image.resize does.  A classifier's argmax predictions,
or a segmentation model's per-sample metric vectors (sigmoid, threshold,
eval/metrics.py), stay on the device until the split ends and are read
once; `classification_metrics` or `average_segmentation_metrics` then
computes the reference's figures.  Log lines, the summary tables and
skip-on-missing-weights follow the JAX package word for word.

Differences from the JAX package:
- weights come only from the reference's torch `.pt` state dicts
  (`{weights_root}/classification_models/{name}_best_acc.pt`,
  `{weights_root}/segmentation_models/{name}_best_loss.pt`), which load
  into the port's models, named as the reference's, with strict=True; the
  port's trainer writes the same files (train/checkpoint.py).  CLIP's and
  CLIPSeg's extra inputs (prompt features, conditional embedding) come
  from the file's aux tensors when the port's finetuners wrote it, else
  from the checkpoint's own text tower and the prompt ids
  (interop/prompts.py), computed on the eval device;
- under a mesh (a parallel.DataParallelGroup, one process per card) each
  rank runs its rows of every batch, padded to the group's size by a
  shallow copy of the loader; the per-sample outputs are gathered with one
  all_gather at the end of the split and trimmed to the real rows, so
  every rank computes the metrics of the whole split
  (medseg_tpu/eval/harness.py:220-231 shards one array instead);
- no retry: `_evaluate_with_retry` guarded against a relay the card does not
  use, so test_all_models calls evaluate_model directly.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from medseg_tpu_torch.core import config as C
from medseg_tpu_torch.core.config import CLASSES, EvalConfig
from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.registry import get_model
from medseg_tpu_torch.data.loader import BatchLoader
from medseg_tpu_torch.eval import metrics as M
from medseg_tpu_torch.ops.augment import preprocess_eval_batch
from medseg_tpu_torch.ops.clip_prep import clip_preprocess
from medseg_tpu_torch.ops.image import resize_jax
from medseg_tpu_torch.train.checkpoint import split_aux

CLS_MODELS = ("ResNet18", "ResNet50", "VGG16", "VGG19", "CLIP")
SEG_MODELS = ("ResNetUnet", "AttentionUNet", "R2Unet", "R2AttUnet", "CLIPSeg")
_SEG_NAMES = {m.lower() for m in SEG_MODELS}

Bundle = Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]


def load_model_bundle(name: str, weights_root: str, seg: bool,
                      device: DeviceLike = None) -> Optional[Bundle]:
    """(state_dict, extra_inputs) from the reference's torch .pt for `name`,
    or None when it is missing.  For CLIP and CLIPSeg, extra_inputs holds
    the prompt features ("text_features") or the conditional embedding
    ("cond") on `device` (the card unless "cpu"): the file's own aux
    tensors when a finetuner wrote them (train/checkpoint.save_best), as
    the JAX harness reads an orbax tree's aux first; else computed from
    the checkpoint's own text tower and the prompt ids (tester.py:559-565,
    642-648).  The state dict is the image side's (CLIP) or the full
    model's (CLIPSeg); the other models have no extra inputs."""
    sub = "segmentation_models" if seg else "classification_models"
    suffix = "best_loss" if seg else "best_acc"
    pt_path = Path(weights_root) / sub / f"{name}_{suffix}.pt"
    if not pt_path.exists():
        return None
    sd, aux = split_aux(torch.load(str(pt_path), map_location="cpu", weights_only=True))
    lname = name.lower()
    if aux:  # a finetuner's own file (medseg_tpu/eval/harness.py:48-53)
        from medseg_tpu_torch.interop.text_features import (classifier_state_dict,
                                                            hf_state_dict)

        device = resolve_device(device)
        sd = classifier_state_dict(sd) if lname == "clip" else hf_state_dict(sd)
        return sd, {k: v.to(device) for k, v in aux.items()}
    if lname == "clip":
        from medseg_tpu_torch.interop.text_features import clip_bundle_from_torch_sd

        sd, tf = clip_bundle_from_torch_sd(sd, device=device)
        return sd, {"text_features": tf}
    if lname == "clipseg":
        from medseg_tpu_torch.interop.text_features import clipseg_bundle_from_torch_sd

        sd, cond = clipseg_bundle_from_torch_sd(sd, device=device)
        return sd, {"cond": cond}
    return sd, {}


def _clip_grid(name: str) -> Optional[int]:
    """CLIP's or CLIPSeg's input grid (CLIP_IMG_SIZE, CLIPSEG_IMG_SIZE, read
    at call time), or None for the other models."""
    return {"clip": C.CLIP_IMG_SIZE, "clipseg": C.CLIPSEG_IMG_SIZE}.get(name.lower())


def _split_rows(parts: List[torch.Tensor], loader: BatchLoader) -> torch.Tensor:
    """The split's per-sample rows in order with the pad rows trimmed;
    parts[i] holds this rank's rows of batch i.  Under a group every
    rank's rows are gathered (one all_gather) and interleaved batch by
    batch."""
    group = getattr(loader, "group", None)
    if group is None:
        return torch.cat([p[:n] for p, n in zip(parts, loader.real_counts())])
    ranks = group.all_gather(torch.cat(parts))
    out, start = [], 0
    for p, n in zip(parts, loader.global_real_counts()):
        b = p.shape[0]
        out.append(torch.cat([r[start:start + b] for r in ranks])[:n])
        start += b
    return torch.cat(out)


def _eval_classification(model, loader: BatchLoader, device: torch.device,
                         extra: Dict[str, torch.Tensor], clip_size: Optional[int]):
    rows = []
    with torch.inference_mode():
        for images, targets in loader:
            images = images.to(device)
            if clip_size is None:
                x, _ = preprocess_eval_batch(images)
            else:  # bicubic resize + CLIP normalize (tester.py:341-371)
                x = clip_preprocess(images, clip_size)
            p = model(x, **extra).argmax(-1)
            rows.append(torch.stack([p, targets.to(device=p.device, dtype=p.dtype)], 1))
    # one fetch for the whole split: a per-batch fetch would wait on the card
    preds, labels = _split_rows(rows, loader).cpu().numpy().T
    return M.classification_metrics(preds, labels, num_classes=len(CLASSES))


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
                       threshold: float, extra: Dict[str, torch.Tensor],
                       clip_size: Optional[int]):
    names, rows = None, []
    with torch.inference_mode():
        for images, masks in loader:
            images, masks = images.to(device), masks.to(device)
            if clip_size is None:
                x, m = preprocess_eval_batch(images, masks)
                probs = torch.sigmoid(model(x, **extra).to(torch.float32))
            else:
                # CLIPSeg (tester.py:430-487): CLIP preprocess at 352, sigmoid
                # on that grid, bilinear resize down to the mask's grid; the
                # mask's /255 alone, with no kernel launch for the image half
                m = masks[..., None].to(torch.float32) / 255.0
                logits = model(clip_preprocess(images, clip_size), **extra)
                probs = torch.sigmoid(logits.to(torch.float32))[..., None]
                probs = resize_jax(probs, m.shape[1], m.shape[2], "bilinear")
            metrics = M.segmentation_metrics_batched(probs, m, threshold)
            names = list(metrics)
            rows.append(torch.stack(list(metrics.values()), 1))
    # one fetch for the whole split (see _eval_classification)
    per_sample = _split_rows(rows, loader).cpu().numpy().T
    return M.average_segmentation_metrics(dict(zip(names, per_sample)))


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
                   extra_inputs: Optional[Dict[str, torch.Tensor]] = None,
                   log: Callable[[str], None] = print, mesh=None,
                   device: DeviceLike = None) -> Optional[Dict]:
    """Evaluate one model; loads its weights (and CLIP's or CLIPSeg's extra
    inputs) if `state_dict` is None, and returns None (after a warning) when
    they are missing.  extra_inputs the caller passes override the loaded
    ones; with an explicit state_dict, CLIP needs "text_features" and
    CLIPSeg "cond" there.

    The model is built in the factory's default dtype (float32) on `device`
    (the card unless device="cpu"), and each batch is moved there.
    mesh: a parallel.DataParallelGroup to split each batch over (device
    defaults to its rank's); every rank returns the split's metrics, and
    the caller's loader comes back untouched."""
    device = resolve_device(mesh.device if device is None and mesh is not None
                            else device)
    seg = name.lower() in _SEG_NAMES
    if state_dict is None:
        bundle = load_model_bundle(name, cfg.weights_root, seg, device)
        if bundle is None:
            log(f"\n[WARNING] Weights not found for {name}")
            log(f"Skipping {name}...")
            return None
        state_dict, auto_extra = bundle
        # caller-supplied extras override the checkpoint's own
        extra_inputs = {**auto_extra, **(extra_inputs or {})}
    if mesh is not None:
        # a shallow copy, so the caller's loader is not left split or padded
        loader = copy.copy(loader)
        loader.group = mesh
        loader.pad_to_multiple = mesh.size
    model = get_model(name)["factory"](device=device)
    model.load_state_dict(state_dict, strict=True)
    model.eval()
    extra = {k: torch.as_tensor(v).to(device) for k, v in (extra_inputs or {}).items()}
    log(f"\n{'=' * 60}")
    log(f"Testing {'Segmentation' if seg else 'Classification'} Model: {name}")
    log(f"{'=' * 60}")
    if seg:
        res = _eval_segmentation(model, loader, device, cfg.threshold, extra,
                                 _clip_grid(name))
        _log_segmentation(name, res, log)
    else:
        res = _eval_classification(model, loader, device, extra, _clip_grid(name))
        _log_classification(name, res, log)
    log("=" * 60 + "\n")
    return res


def test_all_models(cls_loader: Optional[BatchLoader],
                    seg_loader: Optional[BatchLoader],
                    cfg: EvalConfig = EvalConfig(), *,
                    extra_inputs: Optional[Dict[str, dict]] = None,
                    log: Callable[[str], None] = print, mesh=None,
                    device: DeviceLike = None) -> Dict[str, Dict]:
    """Evaluate the whole zoo (tester.py:513-735): models without weights are
    skipped, and a model that fails is logged and skipped; returns
    {model: metrics}.  extra_inputs: {model name: its extra inputs}, each
    overriding what its checkpoint gives.  Without a card it raises before
    the first model unless device="cpu"."""
    device = resolve_device(mesh.device if device is None and mesh is not None
                            else device)
    results: Dict[str, Dict] = {}
    extra_inputs = extra_inputs or {}

    def run_family(loader, names):
        for name in names:
            try:
                res = evaluate_model(name, loader, None, cfg,
                                     extra_inputs=extra_inputs.get(name), log=log,
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
