"""The explicit-collective data-parallel train step.

Counterpart of medseg_tpu/parallel/spmd.py:30-69, the shard_map + psum
form of the classification step: each rank runs its rows with per-rank
BatchNorm (the ordinary module, statistics over its own rows), and one
all-reduce then averages the gradients, the loss and the BatchNorm running
statistics, and sums the correct count.  The default data-parallel path
(train/steps.py under `data_parallel`) takes BatchNorm's statistics over
the global batch instead; the two agree exactly only on a model without
BatchNorm.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from medseg_tpu_torch.parallel.sharding import DataParallelGroup, data_parallel
from medseg_tpu_torch.train import losses

Step = Callable[[torch.Tensor, torch.Tensor, torch.Generator],
                Tuple[torch.Tensor, torch.Tensor]]


def make_cls_train_step_explicit(model: nn.Module, optimizer: torch.optim.Optimizer,
                                 group: DataParallelGroup,
                                 label_smoothing: float = 0.1) -> Step:
    """(images, labels, gen) -> (loss, correct) on this rank's rows; the
    model is in training mode and `optimizer` clips and applies AdamW
    (train/steps.ClippedAdamW).  Every rank draws the dropout for its own
    rows from `gen`, as every shard draws from the one replicated key in
    the JAX step."""

    def step(images: torch.Tensor, labels: torch.Tensor, gen: torch.Generator):
        with data_parallel(None):  # per-rank BatchNorm and draws
            out = model(images, generator=gen)
        loss = losses.cross_entropy(out, labels, label_smoothing)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        correct = (out.detach().argmax(-1) == labels).sum()
        with torch.no_grad():
            grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                     if p.grad is not None]
            stats = [b for name, b in model.named_buffers()
                     if name.endswith(("running_mean", "running_var"))]
            mean = grads + stats + [loss.detach().reshape(1)]
            dt = grads[0].dtype
            flat = torch.cat([t.reshape(-1).to(dt) for t in mean]
                             + [correct.reshape(1).to(dt)])
            group.all_reduce_(flat)
            parts = torch.split(flat, [t.numel() for t in mean] + [1])
            for t, v in zip(mean, parts):
                t.copy_((v / group.size).view_as(t))
            correct = parts[-1].round().to(torch.int64).reshape(())
        optimizer.step()
        return mean[-1].reshape(()), correct

    return step
