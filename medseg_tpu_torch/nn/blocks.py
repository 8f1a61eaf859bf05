"""Building blocks for the model zoo.

Parameters and BatchNorm statistics are float32; `Conv2d` and `BatchNorm2d`
compute in a configurable dtype (bfloat16 for the main path), as flax's
`dtype` argument does in the JAX package.  BatchNorm keeps torch's momentum
0.1 (flax 0.9) and eps 1e-5.  The functional helpers take NHWC, like their
JAX counterparts in medseg_tpu/nn/blocks.py; the models run their convs on
NCHW views with channels_last memory, which cost no copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose float32 parameters are cast to `compute_dtype` for the
    product; the output is in `compute_dtype`."""

    def __init__(self, *args, compute_dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return self._conv_forward(x.to(cd), self.weight.to(cd), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d that normalizes in float32 and returns `compute_dtype`,
    as flax's BatchNorm(dtype=...) does."""

    def __init__(self, *args, compute_dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.compute_dtype))


def max_pool(x: torch.Tensor, window: int = 2, stride: int | None = None,
             padding: int = 0) -> torch.Tensor:
    """NHWC max pool; padded positions never win (they hold -inf)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride or window, padding)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B,H,W,C] -> [B,C]."""
    return x.mean(dim=(1, 2))


class ClassifierHead(nn.Sequential):
    """Dropout(p) + Linear(num_classes), float32: the transfer-learning head
    the reference swaps onto every classifier (utils/helpers.py:124-144).
    Held as `fc`, its Linear is `fc.1`, as in the reference's state dicts."""

    def __init__(self, in_features: int, num_classes: int, dropout: float = 0.5):
        super().__init__(nn.Dropout(dropout), nn.Linear(in_features, num_classes))
