"""Classification losses with the reference's semantics.

Counterpart of medseg_tpu/train/losses.py:17-40: cross-entropy with torch
CrossEntropyLoss's label smoothing (target = (1-eps)*onehot + eps/K,
reference utils/helpers.py:244-246) in float32, and the pad-row mask of the
validation loop.  The one-hot is a comparison with an arange on the logits'
device, so nothing here waits for the card.  The segmentation losses
(:43-111) come with the segmentation slice (ROADMAP A.8).
"""

from __future__ import annotations

import torch


def per_sample_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                             label_smoothing: float = 0.0) -> torch.Tensor:
    """[B] CE vector; masked/trimmed aggregation is the caller's choice
    (see valid_mask)."""
    num_classes = logits.shape[-1]
    logits = logits.to(torch.float32)
    classes = torch.arange(num_classes, device=logits.device)
    onehot = (labels[:, None] == classes).to(torch.float32)
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
