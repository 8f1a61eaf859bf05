"""Losses with the reference's semantics, in float32 (float64 for float64
logits, as a float64 model's parity runs need).

Counterpart of medseg_tpu/train/losses.py:
- cross-entropy with torch CrossEntropyLoss's label smoothing (target =
  (1-eps)*onehot + eps/K, reference utils/helpers.py:244-246) and the
  pad-row mask of the validation loop (:17-40);
- binary cross-entropy with logits, mean over all elements, in the stable
  form optax.sigmoid_binary_cross_entropy computes (:73), and its masked
  form over the valid rows of a padded batch (:43);
- the batch IoU of the training loop's validation: one IoU over the whole
  batch, not a mean over samples (:93), and its masked form (:103);
- CLIPSeg's dice loss (sigmoid, smooth 1.0) and 0.5*BCE + 0.5*dice
  (reference utils/clip_seg_finetuner.py:40-74): one dice over every
  element of the batch, not a mean over samples (:56-90), and their masked
  forms over the valid rows of a padded batch.
The one-hot is a comparison with an arange on the logits' device, so
nothing here waits for the card.

Under data parallelism (parallel.data_parallel) the batch-level sums, the
dice's intersection and denominators and the IoU's intersection and
union, reduce over the group through `all_reduce_sum`, so every rank
computes the global batch's dice and IoU; per-sample means need no
collective, since every rank holds the same number of rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medseg_tpu_torch.parallel.sharding import all_reduce_sum


def _loss_dtype(logits: torch.Tensor) -> torch.dtype:
    return torch.promote_types(logits.dtype, torch.float32)


def per_sample_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                             label_smoothing: float = 0.0) -> torch.Tensor:
    """[B] CE vector; masked/trimmed aggregation is the caller's choice
    (see valid_mask)."""
    num_classes = logits.shape[-1]
    logits = logits.to(_loss_dtype(logits))
    classes = torch.arange(num_classes, device=logits.device)
    onehot = (labels[:, None] == classes).to(logits.dtype)
    if label_smoothing:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    return -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    return per_sample_cross_entropy(logits, labels, label_smoothing).mean()


def valid_mask(batch: int, n_valid, device=None) -> torch.Tensor:
    """[B] float mask: 1.0 for the first n_valid rows, 0.0 for pad rows
    (the loader's pad_to_multiple repeats the last sample)."""
    return (torch.arange(batch, device=device) < n_valid).to(torch.float32)


def _sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise optax.sigmoid_binary_cross_entropy in float32 (float64
    for float64 logits):
    -t*log_sigmoid(x) - (1-t)*log_sigmoid(-x)."""
    logits = logits.to(_loss_dtype(logits))
    targets = targets.to(logits.dtype)
    return -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _sigmoid_bce(logits, targets).mean()


def _rows(valid: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B] valid mask broadcast over a tensor of `ndim` dimensions."""
    return valid.reshape((-1,) + (1,) * (ndim - 1))


def masked_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Mean BCE over the valid rows only: bce_with_logits(logits[:n],
    targets[:n]) for valid = n ones and pad zeros."""
    per_elem = _sigmoid_bce(logits, targets)
    per_sample = per_elem[0].numel()
    return ((per_elem * _rows(valid, per_elem.dim())).sum()
            / torch.clamp(valid.sum() * per_sample, min=1.0))


def batch_iou(probs: torch.Tensor, targets: torch.Tensor,
              threshold: float = 0.5) -> torch.Tensor:
    """One IoU over the whole batch (reference utils/helpers.py:223-227)."""
    return masked_batch_iou(probs, targets, torch.ones(probs.shape[0], device=probs.device),
                            threshold)


def masked_batch_iou(probs: torch.Tensor, targets: torch.Tensor,
                     valid: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """batch_iou over the valid rows only (pad rows leave both sums)."""
    v = _rows(valid, probs.dim())
    p = (probs > threshold).to(torch.float32) * v
    t = targets.to(torch.float32) * v
    inter, union = all_reduce_sum(torch.stack([(p * t).sum(),
                                               ((p + t) > 0).to(torch.float32).sum()]))
    return inter / (union + 1e-7)


def masked_dice_loss(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
                     smooth: float = 1.0) -> torch.Tensor:
    """dice_loss over the valid rows only: pad rows leave every sum."""
    v = _rows(valid, logits.dim())
    p = torch.sigmoid(logits.to(_loss_dtype(logits))) * v
    t = targets.to(p.dtype) * v
    return _dice_from_sums(p, t, smooth)


def masked_combined_loss(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
                         bce_weight: float = 0.5, dice_weight: float = 0.5) -> torch.Tensor:
    return (bce_weight * masked_bce_with_logits(logits, targets, valid)
            + dice_weight * masked_dice_loss(logits, targets, valid))


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """1 - dice of sigmoid(logits) and the targets over the whole batch."""
    p = torch.sigmoid(logits.to(_loss_dtype(logits))).reshape(-1)
    t = targets.to(p.dtype).reshape(-1)
    return _dice_from_sums(p, t, smooth)


def _dice_from_sums(p: torch.Tensor, t: torch.Tensor, smooth: float) -> torch.Tensor:
    """1 - (2*sum(p*t) + smooth) / (sum(p) + sum(t) + smooth), the sums
    over the global batch."""
    inter, sp, st = all_reduce_sum(torch.stack([(p * t).sum(), p.sum(), t.sum()]))
    return 1.0 - (2.0 * inter + smooth) / (sp + st + smooth)


def combined_loss(logits: torch.Tensor, targets: torch.Tensor,
                  bce_weight: float = 0.5, dice_weight: float = 0.5) -> torch.Tensor:
    return (bce_weight * bce_with_logits(logits, targets)
            + dice_weight * dice_loss(logits, targets))
