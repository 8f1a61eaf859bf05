"""Building blocks for the model zoo.

Parameters and BatchNorm statistics are float32; `Conv2d` and `BatchNorm2d`
compute in a configurable dtype (bfloat16 for the main path), as flax's
`dtype` argument does in the JAX package.  BatchNorm keeps torch's momentum
0.1 (flax 0.9) and eps 1e-5, and in training blends flax's biased batch
variance into its running variance.  The functional helpers take NHWC, like
their JAX counterparts in medseg_tpu/nn/blocks.py; the models run their
convs on NCHW views with channels_last memory, which cost no copy.
"""

from __future__ import annotations

from typing import Optional

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


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d whose float32 parameters are cast to
    `compute_dtype` for the product (cuDNN's transposed convolution, as
    the JAX package leaves flax's ConvTranspose to XLA)."""

    def __init__(self, *args, compute_dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return F.conv_transpose2d(x.to(cd), self.weight.to(cd), bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d that normalizes in float32 and returns `compute_dtype`,
    as flax's BatchNorm(dtype=...) does.

    Training mode follows flax's BatchNorm (medseg_tpu/nn/blocks.py:122-128):
    batch statistics in float32 whatever the activations' dtype, and the
    running statistics blended as 0.9 * running + 0.1 * batch with the
    *biased* batch variance (torch's own blend takes the unbiased one, 4/3
    of it at n=4 values a channel).  The choice: one
    `torch.native_batch_norm` call without running statistics, which
    normalizes and returns the batch mean and 1/sqrt(var + eps) in float32,
    with ATen's batch-norm backward for autograd; the running statistics
    then update from those under no_grad, var = invstd^-2 - eps, with no
    second pass over the activations.  num_batches_tracked is not counted
    (the momentum is fixed)."""

    def __init__(self, *args, compute_dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(invstd.pow(-2) - self.eps, self.momentum)
        return y


def max_pool(x: torch.Tensor, window: int = 2, stride: int | None = None,
             padding: int = 0) -> torch.Tensor:
    """NHWC max pool; padded positions never win (they hold -inf)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride or window, padding)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B,H,W,C] -> [B,C]."""
    return x.mean(dim=(1, 2))


def dropout(x: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    """flax's nn.Dropout in training: keep each value with probability 1-p,
    drawn from `generator`, and scale the kept ones by 1/(1-p)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


class ClassifierHead(nn.Sequential):
    """Dropout(p) + Linear(num_classes), float32: the transfer-learning head
    the reference swaps onto every classifier (utils/helpers.py:124-144).
    Held as `fc`, its Linear is `fc.1`, as in the reference's state dicts.

    In training, dropout draws from the explicit `generator` (the JAX
    trainer threads a dropout key), never from torch's global RNG."""

    def __init__(self, in_features: int, num_classes: int, dropout: float = 0.5):
        super().__init__(nn.Dropout(dropout), nn.Linear(in_features, num_classes))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p = self[0].p
        if self.training and p > 0.0:
            if generator is None:
                raise ValueError("training-mode dropout draws from an explicit "
                                 "torch.Generator: pass generator=")
            x = dropout(x, p, generator)
        return self[1](x)


class DoubleConv(nn.Sequential):
    """Two Conv3x3 (with bias) + BN + ReLU, NCHW: the U-Nets' `basic_block`
    (medseg_tpu/nn/blocks.py:134-146, reference AttentionUNet.py:4-13).  As
    a Sequential its parameters sit at indices 0, 1, 3 and 4, the
    reference's state-dict keys."""

    def __init__(self, in_ch: int, features: int, dtype=torch.float32):
        super().__init__(
            Conv2d(in_ch, features, 3, 1, 1, compute_dtype=dtype),
            BatchNorm2d(features, compute_dtype=dtype), nn.ReLU(),
            Conv2d(features, features, 3, 1, 1, compute_dtype=dtype),
            BatchNorm2d(features, compute_dtype=dtype), nn.ReLU())
