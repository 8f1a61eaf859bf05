"""CLIPSeg decoder-only finetuning.

Counterpart of medseg_tpu/train/clipseg_finetune.py:44-278 (reference
utils/clip_seg_finetuner.py:121-258): only `decoder.*` trains (the CLIP
backbone runs under no_grad in the model, as in HF); AdamW lr 1e-5 wd 0.01
with cosine annealing, a global-norm clip at 1.0, CombinedLoss = 0.5*BCE +
0.5*dice on the logit grid (352x352), batch 8, full float32 (TF32 off);
the best validation dice is saved as "CLIPSeg" with the conditional
embedding as its aux tensor; early stop after 10 epochs without a new best.

Each step is `clipseg_prep` (clip_preprocess to 352 in float32, no kernel;
the mask /255 resized bilinearly by ops/image.resize_jax to the logit grid,
reference utils/dataset.py:237-244) -> CLIPSegModel with the fixed
embedding broadcast to the batch -> the combined loss -> backward -> clip +
AdamW.  A ragged train batch is padded to the full batch by repeating its
last row and takes the masked loss: pad rows add literal zeros to every
sum, so the step equals the ragged batch's, and every step has the same
shapes (what a CUDA graph of the step needs).  Ragged validation batches
pad the same way.  The validation dice is one dice over each batch's valid
rows, averaged over batches unweighted.  Statistics stay on the device and
are read once an epoch.

Data parallelism (`mesh`, medseg_tpu/train/clipseg_finetune.py:78-99), as
in clip_finetune.py: train batches drop their ragged tails (no padded
masked tail under a mesh, :170), validation pads to the group's size, and
the dice's sums are the global batch's (train/losses.py).

Not ported: `scan_chunk` (A.16).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from medseg_tpu_torch.core import config as C
from medseg_tpu_torch.core.config import CLIPSegFinetuneConfig
from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.precision import full_float32
from medseg_tpu_torch.data.loader import BatchLoader, mesh_loaders
from medseg_tpu_torch.ops.clip_prep import clip_preprocess
from medseg_tpu_torch.ops.image import resize_jax
from medseg_tpu_torch.parallel.sharding import (all_reduce_sum, current_group,
                                                data_parallel, replicate_)
from medseg_tpu_torch.train import checkpoint as ckpt
from medseg_tpu_torch.train import losses
from medseg_tpu_torch.train import steps as S
from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable
from medseg_tpu_torch.train.schedules import EarlyStopping, cosine_annealing


def batch_dice(probs: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
               threshold: float = 0.5) -> torch.Tensor:
    """One dice over the batch's valid rows (clipseg_finetune.py:34-41):
    pad rows leave every sum; under data parallelism the sums are the
    global batch's."""
    v = valid.reshape((-1,) + (1,) * (probs.dim() - 1))
    p = (probs > threshold).to(torch.float32) * v
    t = (targets > threshold).to(torch.float32) * v
    inter, sp, st = all_reduce_sum(torch.stack([(p * t).sum(), p.sum(), t.sum()]))
    return (2.0 * inter + 1e-7) / (sp + st + 1e-7)


def clipseg_prep(images_u8: torch.Tensor, masks_u8: torch.Tensor, image_size: int,
                 logit_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(CLIP-normalized [B,S,S,3] float32, masks in [0, 1] [B,L,L] float32
    on the logit grid) (clipseg_finetune.py:111-117)."""
    x = clip_preprocess(images_u8, image_size)
    m = masks_u8.to(torch.float32)[..., None] / 255.0
    return x, resize_jax(m, logit_size, logit_size, "bilinear")[..., 0]


def pad_rows(reps: int, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each tensor with its last row repeated `reps` more times."""
    return tuple(torch.cat([t, t[-1:].expand(reps, *t.shape[1:])]) for t in tensors)


def clipseg_train_step(model: nn.Module, optimizer: S.ClippedAdamW,
                       images_u8: torch.Tensor, masks_u8: torch.Tensor, cond: torch.Tensor,
                       logit_size: int, image_size: int, n_valid: Optional[int] = None,
                       bce_weight: float = 0.5,
                       dice_weight: float = 0.5) -> torch.Tensor:
    """One step (clipseg_finetune.py:126-177): the combined loss of a full
    batch, or with n_valid the masked combined loss over its first n_valid
    rows (a padded ragged batch) -> backward -> clip + AdamW.  Returns the
    loss as a device scalar."""
    x, m = clipseg_prep(images_u8, masks_u8, image_size, logit_size)
    logits = model(x, cond=cond.expand(x.shape[0], -1))
    if n_valid is None:
        loss = losses.combined_loss(logits, m, bce_weight, dice_weight)
    else:
        valid = losses.valid_mask(x.shape[0], n_valid, logits.device)
        loss = losses.masked_combined_loss(logits, m, valid, bce_weight, dice_weight)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss, = S.all_reduce_step_(optimizer, loss.detach())
    optimizer.step()
    return loss


@torch.no_grad()
def clipseg_eval_step(model: nn.Module, images_u8: torch.Tensor, masks_u8: torch.Tensor,
                      cond: torch.Tensor, n_valid: int, logit_size: int,
                      image_size: int, bce_weight: float = 0.5,
                      dice_weight: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked loss * max(n_valid, 1), batch dice) over the first n_valid
    rows (clipseg_finetune.py:195-204).  Under data parallelism both are
    the group's: each rank's masked loss times its own real rows (a rank
    of pad rows alone adds 0), summed."""
    x, m = clipseg_prep(images_u8, masks_u8, image_size, logit_size)
    logits = model(x, cond=cond.expand(x.shape[0], -1))
    valid = losses.valid_mask(x.shape[0], n_valid, logits.device)
    loss = losses.masked_combined_loss(logits, m, valid, bce_weight, dice_weight)
    dice = batch_dice(torch.sigmoid(logits), m, valid)
    if current_group() is not None:
        return all_reduce_sum(loss * n_valid), dice
    return loss * max(n_valid, 1), dice


def finetune_clipseg(
    train_loader: BatchLoader,
    val_loader: BatchLoader,
    model: nn.Module,
    cond,
    cfg: CLIPSegFinetuneConfig = CLIPSegFinetuneConfig(),
    *,
    save: bool = True,
    image_size: Optional[int] = None,
    log: Callable[[str], None] = print,
    device: DeviceLike = None,
    mesh=None,
) -> float:
    """Finetune CLIPSeg's decoder; returns the best validation dice.

    model: the CLIPSegModel holding the weights to finetune (the JAX
    package's `variables`), trained in place on `device` (the card unless
    "cpu" is passed).  cond: [1, dim] conditional embedding of the fixed
    prompt.  image_size: the grid (default CLIPSEG_IMG_SIZE, read at call
    time; tests with tiny towers pass theirs).  mesh: a
    parallel.DataParallelGroup to train over (device defaults to its
    rank's); the caller's loaders come back untouched."""
    device = resolve_device(mesh.device if device is None and mesh is not None
                            else device)
    image_size = image_size or C.CLIPSEG_IMG_SIZE
    model.to(device)
    rows = 1  # global rows per local row
    if mesh is not None:
        train_loader, val_loader = mesh_loaders(mesh, train_loader, val_loader)
        replicate_(model, mesh)
        rows = mesh.size
    cond = torch.as_tensor(cond, dtype=torch.float32).to(device)
    optimizer = S.build_optimizer(cfg.lr, cfg.weight_decay, 1.0,  # clip_seg_finetuner.py:172
                                  set_trainable(model, finetune_filter("CLIPSeg")))
    logit_size = model.logit_size(image_size)
    step_kw = dict(image_size=image_size, bce_weight=cfg.bce_weight,
                   dice_weight=cfg.dice_weight)
    # a rank's rows of a full batch
    bs_full, val_rows = train_loader.batch_size // rows, val_loader.batch_size // rows

    stopper = EarlyStopping(cfg.early_stop_patience, mode="max")
    best = 0.0
    start = time.time()
    with full_float32(), data_parallel(mesh):
        for epoch in range(1, cfg.epochs + 1):
            S.set_learning_rate(optimizer, cosine_annealing(cfg.lr, epoch - 1, cfg.epochs))
            model.train()
            loss_acc = torch.zeros((), dtype=torch.float32, device=device)
            total = 0
            for images, masks in train_loader:
                images, masks = images.to(device), masks.to(device)
                b = images.shape[0]
                n_valid = None
                if b < bs_full:  # the ragged tail: padded, masked loss
                    images, masks = pad_rows(bs_full - b, images, masks)
                    n_valid = b
                loss = clipseg_train_step(model, optimizer, images, masks, cond, logit_size,
                                          n_valid=n_valid, **step_kw)
                loss_acc += loss * (b * rows)
                total += b * rows
            run_loss = loss_acc.item()

            model.eval()
            vloss_acc = torch.zeros((), dtype=torch.float32, device=device)
            dices = []
            val_total = 0
            for (images, masks), n_real, n_global in zip(
                    val_loader, val_loader.real_counts(), val_loader.global_real_counts()):
                images, masks = images.to(device), masks.to(device)
                if images.shape[0] < val_rows:
                    images, masks = pad_rows(val_rows - images.shape[0], images, masks)
                loss_sum, dice = clipseg_eval_step(model, images, masks, cond, n_real,
                                                   logit_size, **step_kw)
                vloss_acc += loss_sum
                dices.append(dice)
                val_total += n_global
            mean_dice = torch.stack(dices).mean() if dices else torch.zeros((), device=device)
            val_loss, val_dice = torch.stack([vloss_acc, mean_dice]).double().tolist()
            log(f"[CLIPSeg] Ep{epoch}: TrainLoss {run_loss / max(1, total):.3f} | "
                f"ValLoss {val_loss / max(1, val_total):.3f} | "
                f"ValDice {val_dice:.3f}")

            if stopper.update(val_dice):
                best = val_dice
                if save:
                    # the embedding rides along, so eval and serving need
                    # no prompt ids
                    ckpt.save_best(str(Path(cfg.save_root) / "segmentation_models"),
                                   "CLIPSeg", model, True,
                                   meta={"epoch": epoch, "dice": val_dice},
                                   aux={"cond": cond}, group=mesh)
                    log(f"Saved best model (Dice: {val_dice:.4f})")
            if stopper.should_stop:
                log(f"Early stopping at epoch {epoch}. Best dice: {best:.4f}")
                break
    log(f"\nTraining finished in {(time.time() - start) / 60:.2f} minutes.")
    return best
