"""CLIP vision-tower finetuning.

Counterpart of medseg_tpu/train/clip_finetune.py:36-211 (reference
utils/clip_finetuner.py:85-192): the text features of the three prompts
are computed once and fixed; only the vision tower trains (the projection
and logit_scale keep their values); AdamW lr 5e-6 wd 5e-4 with cosine
annealing over the epochs, plain CE (no label smoothing), a global-norm
clip at 1.0, batch 32, full float32 (TF32 off, core/precision.full_float32);
the best validation accuracy is saved as "CLIP" with the text features as
its aux tensors, so eval and serving need no prompt ids; early stop after
10 epochs without a new best.

Each step is clip_preprocess (the packed 256 batch resized bicubically to
224 in float32 and normalized: plain torch operations, no kernel, as the
JAX package leaves them to XLA) -> CLIPClassifier -> CE -> backward ->
clip + AdamW over `vision_model.*` only.  Training statistics and the
validation sums stay on the device and are read once an epoch.

Data parallelism (`mesh`, medseg_tpu/train/clip_finetune.py:72-93), as
train/trainer.py has it: the rank's rows of each global batch, train
batches without ragged tails, validation padded to the group's size and
masked, the weights broadcast from rank 0, the gradients averaged before
the clip, the statistics the group's; rank 0 writes the checkpoint.

Not ported: `scan_chunk` (A.16: its CUDA form is a graph of the step, A.7).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from medseg_tpu_torch.core import config as C
from medseg_tpu_torch.core.config import CLIPFinetuneConfig
from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.precision import full_float32
from medseg_tpu_torch.data.loader import BatchLoader, mesh_loaders
from medseg_tpu_torch.ops.clip_prep import clip_preprocess
from medseg_tpu_torch.parallel.sharding import data_parallel, replicate_
from medseg_tpu_torch.train import checkpoint as ckpt
from medseg_tpu_torch.train import losses
from medseg_tpu_torch.train import steps as S
from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable
from medseg_tpu_torch.train.schedules import EarlyStopping, cosine_annealing


def clip_train_step(model: nn.Module, optimizer: S.ClippedAdamW, images_u8: torch.Tensor,
                    labels: torch.Tensor, text_features: torch.Tensor,
                    image_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step (clip_finetune.py:95-107): preprocess -> logits against the
    text features -> CE -> backward -> clip + AdamW.  Returns (loss,
    correct) as device scalars; the clipped gradients stay in .grad."""
    logits = model(clip_preprocess(images_u8, image_size), text_features)
    loss = losses.cross_entropy(logits, labels)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss, correct = S.all_reduce_step_(optimizer, loss.detach(),
                                       (logits.detach().argmax(-1) == labels).sum())
    optimizer.step()
    return loss, correct


@torch.no_grad()
def clip_eval_step(model: nn.Module, images_u8: torch.Tensor, labels: torch.Tensor,
                   text_features: torch.Tensor, n_valid: int,
                   image_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_sum, correct) over the first n_valid rows (clip_finetune.py:
    138-145)."""
    x = clip_preprocess(images_u8, image_size)
    loss_sum, correct, _ = S.cls_eval_step(lambda v: model(v, text_features), x, labels,
                                           n_valid, label_smoothing=0.0)
    return loss_sum, correct


def finetune_clip(
    train_loader: BatchLoader,
    val_loader: BatchLoader,
    model: nn.Module,
    text_features,
    cfg: CLIPFinetuneConfig = CLIPFinetuneConfig(),
    *,
    save: bool = True,
    image_size: Optional[int] = None,
    log: Callable[[str], None] = print,
    device: DeviceLike = None,
    mesh=None,
) -> float:
    """Finetune CLIP's vision tower; returns the best validation accuracy (%).

    model: the CLIPClassifier holding the weights to finetune (the JAX
    package's `variables`), trained in place on `device` (the card unless
    "cpu" is passed).  text_features: [num_classes, dim] L2-normalized
    prompt features.  image_size: the grid (default CLIP_IMG_SIZE, read at
    call time; tests with tiny towers pass theirs).  mesh: a
    parallel.DataParallelGroup to train over (device defaults to its
    rank's); the caller's loaders come back untouched."""
    device = resolve_device(mesh.device if device is None and mesh is not None
                            else device)
    image_size = image_size or C.CLIP_IMG_SIZE
    model.to(device)
    rows = 1  # global rows per local row
    if mesh is not None:
        train_loader, val_loader = mesh_loaders(mesh, train_loader, val_loader)
        replicate_(model, mesh)
        rows = mesh.size
    tf = torch.as_tensor(text_features, dtype=torch.float32).to(device)
    optimizer = S.build_optimizer(cfg.lr, cfg.weight_decay, cfg.grad_clip_norm,
                                  set_trainable(model, finetune_filter("CLIP")))

    stopper = EarlyStopping(cfg.early_stop_patience, mode="max")
    best = 0.0
    start = time.time()
    with full_float32(), data_parallel(mesh):
        for epoch in range(1, cfg.epochs + 1):
            S.set_learning_rate(optimizer, cosine_annealing(cfg.lr, epoch - 1, cfg.epochs))

            # statistics stay on the device: one read an epoch
            model.train()
            loss_acc = torch.zeros((), dtype=torch.float32, device=device)
            corr_acc = torch.zeros((), dtype=torch.int64, device=device)
            total = 0
            for images, labels in train_loader:
                images, labels = images.to(device), labels.to(device)
                loss, corr = clip_train_step(model, optimizer, images, labels, tf,
                                             image_size)
                loss_acc += loss * (images.shape[0] * rows)
                corr_acc += corr
                total += images.shape[0] * rows
            run_loss, correct = torch.stack([loss_acc.double(), corr_acc.double()]).tolist()

            model.eval()
            vloss_acc = torch.zeros((), dtype=torch.float32, device=device)
            vcorr_acc = torch.zeros((), dtype=torch.int64, device=device)
            val_total = 0
            for (images, labels), n_real, n_global in zip(
                    val_loader, val_loader.real_counts(), val_loader.global_real_counts()):
                loss_sum, corr = clip_eval_step(model, images.to(device), labels.to(device),
                                                tf, n_real, image_size)
                vloss_acc += loss_sum
                vcorr_acc += corr
                val_total += n_global
            val_loss, val_correct = torch.stack([vloss_acc.double(),
                                                 vcorr_acc.double()]).tolist()
            val_acc = 100.0 * val_correct / max(1, val_total)
            log(f"[CLIP] Ep{epoch}: TrainLoss {run_loss / max(1, total):.3f} "
                f"(Acc {100.0 * correct / max(1, total):.2f}%) | "
                f"ValLoss {val_loss / max(1, val_total):.3f} | ValAcc {val_acc:.2f}%")

            if stopper.update(val_acc):
                best = val_acc
                if save:
                    # the prompt features ride along, so eval and serving
                    # need no prompt ids
                    ckpt.save_best(str(Path(cfg.save_root) / "classification_models"),
                                   "CLIP", model, False,
                                   meta={"epoch": epoch, "score": val_acc},
                                   aux={"text_features": tf}, group=mesh)
                    log(f"Saved best model (Acc: {val_acc:.2f}%)")
            if stopper.should_stop:
                log(f"Early stopping at epoch {epoch}. Best accuracy: {best:.2f}%")
                break
    log(f"\nTraining finished in {(time.time() - start) / 60:.2f} minutes.")
    log(f"Best Validation Accuracy: {best:.2f}%")
    return best
