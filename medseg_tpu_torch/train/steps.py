"""The optimizer stack and the train and eval steps.

Counterpart of medseg_tpu/train/steps.py:32-56 (optimizer), :68-95 and
:111-141 (classification and segmentation train steps) and :274-313 (the
eval steps).  The optimizer holds only the trainable parameters
(train/freeze.py); its step clips their gradients by global norm as
optax's clip_by_global_norm does, then applies AdamW.  The learning rate
lives in the param groups and is set per epoch from the host.

No step reads a value back to the host: the clip decides with
`torch.where` on the card, and losses, correct counts and IoUs are
returned as device tensors for the caller to accumulate.  In bf16 the parameters stay
float32 and the convs cast them per forward (nn/blocks.py), so gradients
reach them through the cast, as with flax's `dtype`: no autocast, no loss
scaling.

Under data parallelism (parallel.data_parallel, the JAX steps jitted over
a sharded batch) a train step averages the gradients over the group in one
flattened all-reduce, together with the loss and the correct count, before
the clip and AdamW: clipping each rank's own gradients first would give
another update.  The eval steps return the group's loss sums, correct
counts and IoU.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import torch
from torch import nn

from medseg_tpu_torch.parallel.sharding import all_reduce_sum, current_group
from medseg_tpu_torch.train import losses

Prep = Callable[[torch.Generator, torch.Tensor, torch.Tensor],
                Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g * (max_norm / |g|) where the
    global norm |g| >= max_norm, g unchanged below it (no epsilon, unlike
    clip_grad_norm_).  Returns the norm before clipping, on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class ClippedAdamW(torch.optim.AdamW):
    """AdamW whose step first clips the gradients of its parameters by
    global norm (optax.chain(clip_by_global_norm, adamw))."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float,
                 weight_decay: float, clip_norm: float):
        params = list(params)
        # fused: one multi-tensor kernel per step on the card
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay,
                         fused=params[0].is_cuda or None)
        self.clip_norm = clip_norm

    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups for p in group["params"]
                 if p.grad is not None]
        clip_by_global_norm_(grads, self.clip_norm)
        return super().step(closure)


def build_optimizer(lr: float, weight_decay: float, clip_norm: float,
                    trainable: Iterable[nn.Parameter]) -> ClippedAdamW:
    """Global-norm clip + AdamW(betas 0.9/0.999, eps 1e-8) over `trainable`
    only: frozen parameters are absent, so they get no update, no weight
    decay and no share of the norm."""
    return ClippedAdamW(trainable, lr, weight_decay, clip_norm)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


@torch.no_grad()
def all_reduce_step_(optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                     *counts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Under a joined data-parallel group: one all-reduce of the gradients
    of `optimizer`'s parameters, the loss and `counts`, flattened into one
    bucket; the gradients (in place) and the loss come back averaged over
    the ranks, the counts summed.  Otherwise (loss, *counts) as given."""
    group = current_group()
    if group is None or not group.joined:
        return (loss, *counts)
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    dt = grads[0].dtype
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [t.reshape(1).to(dt) for t in (loss, *counts)])
    group.all_reduce_(flat)
    parts = torch.split(flat, [g.numel() for g in grads] + [1] * (1 + len(counts)))
    for g, v in zip(grads, parts):
        g.copy_(v.view_as(g))
    torch._foreach_mul_(grads, 1.0 / group.size)
    loss = (parts[len(grads)] / group.size).reshape(()).to(loss.dtype)
    return (loss, *(v.round().reshape(()).to(c.dtype)
                    for v, c in zip(parts[len(grads) + 1:], counts)))


def cls_train_step(model: nn.Module, optimizer: ClippedAdamW,
                   images: torch.Tensor, labels: torch.Tensor,
                   gen: torch.Generator, label_smoothing: float = 0.1,
                   prep: Optional[Prep] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: prep (the augmentation, drawing from `gen`) -> train-mode
    forward (dropout drawing from `gen`) -> label-smoothed CE -> backward
    -> clip + AdamW.  The model is in training mode.  Returns (loss,
    correct) as device scalars; the clipped gradients stay in .grad."""
    if prep is not None:
        images, labels = prep(gen, images, labels)
    out = model(images, generator=gen)
    loss = losses.cross_entropy(out, labels, label_smoothing)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss, correct = all_reduce_step_(optimizer, loss.detach(),
                                     (out.detach().argmax(-1) == labels).sum())
    optimizer.step()
    return loss, correct


@torch.no_grad()
def cls_eval_step(model: nn.Module, images: torch.Tensor, labels: torch.Tensor,
                  n_valid: int, label_smoothing: float = 0.1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss_sum, correct, preds) over the first n_valid rows: pad rows
    (repeats of the last sample, loader pad_to_multiple) add nothing.  The
    model is in eval mode."""
    out = model(images)
    valid = losses.valid_mask(images.shape[0], n_valid, out.device)
    loss_sum = (losses.per_sample_cross_entropy(out, labels, label_smoothing)
                * valid).sum()
    preds = out.argmax(-1)
    correct = ((preds == labels) & (valid > 0)).sum()
    if current_group() is not None:  # the group's sums; preds stay this rank's
        loss_sum, total = all_reduce_sum(torch.stack([loss_sum, correct.to(loss_sum.dtype)]))
        correct = total.round().to(correct.dtype)
    return loss_sum, correct, preds


def seg_train_step(model: nn.Module, optimizer: ClippedAdamW,
                   images: torch.Tensor, masks: torch.Tensor,
                   gen: torch.Generator, prep: Optional[Prep] = None) -> torch.Tensor:
    """One step: prep (the augmentation with the mask, drawing from `gen`)
    -> train-mode forward -> BCE with logits -> backward -> clip + AdamW.
    The model is in training mode, so every BatchNorm, a frozen encoder's
    too, normalizes with batch statistics and updates its running ones, as
    flax's mutable batch_stats do whatever the optimizer's mask says.
    Frozen parameters (requires_grad False) get no gradient and are not in
    the optimizer.  Returns the loss as a device scalar."""
    if prep is not None:
        images, masks = prep(gen, images, masks)
    loss = losses.bce_with_logits(model(images), masks)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss, = all_reduce_step_(optimizer, loss.detach())
    optimizer.step()
    return loss


@torch.no_grad()
def seg_eval_step(model: nn.Module, images: torch.Tensor, masks: torch.Tensor,
                  n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_sum, batch IoU) over the first n_valid rows: the masked mean
    BCE times max(n_valid, 1), and the masked batch IoU of sigmoid(logits)
    at 0.5 (both the group's under data parallelism).  The model is in
    eval mode."""
    out = model(images)
    valid = losses.valid_mask(images.shape[0], n_valid, out.device)
    loss = losses.masked_bce_with_logits(out, masks, valid)
    iou = losses.masked_batch_iou(torch.sigmoid(out), masks, valid)
    return all_reduce_sum(loss * max(n_valid, 1)), iou
