"""Building blocks for the model zoo.

Parameters and BatchNorm statistics are float32; `Conv2d` and `BatchNorm2d`
compute in a configurable dtype (bfloat16 for the main path), as flax's
`dtype` argument does in the JAX package.  BatchNorm keeps torch's momentum
0.1 (flax 0.9) and eps 1e-5, and in training blends flax's biased batch
variance into its running variance.  The functional helpers take NHWC, like
their JAX counterparts in medseg_tpu/nn/blocks.py; the models and the
module blocks run on NCHW views with channels_last memory, which cost no
copy.

The U-Net blocks (UpConv, AttentionGate, RecurrentBlock, RRCNNBlock) are
the unfused default forms of medseg_tpu/nn/blocks.py:148-384, under the
reference's module names; the JAX package's opt-in lowering twins
(AttentionGate's fused_stats, RecurrentBlock's use_scan, nn/s2d.py) wait
for ROADMAP A.16.
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


class Linear(nn.Linear):
    """nn.Linear whose float32 parameters are cast to `compute_dtype` for the
    product (flax's Dense(dtype=...)); the output is in `compute_dtype`."""

    def __init__(self, *args, compute_dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), bias)


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


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest 2x upsample (torch nn.Upsample(scale_factor=2)'s
    default): each value copied to a 2x2 cell."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B,H,W,C] -> [B,C]."""
    return x.mean(dim=(1, 2))


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC torch AdaptiveAvgPool2d: bin i of n inputs to o outputs is
    [floor(i*n/o), ceil((i+1)*n/o)), so 8 -> 7 overlaps.  Pools in float32
    (float64 for a float64 input), as medseg_tpu/nn/blocks.py:37-55 does;
    at the output size it returns x unchanged, in its own dtype."""
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    y = F.adaptive_avg_pool2d(
        x.permute(0, 3, 1, 2).to(torch.promote_types(x.dtype, torch.float32)),
        (out_h, out_w))
    return y.permute(0, 2, 3, 1)


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


class UpConv(nn.Module):
    """Nearest 2x upsample + Conv3x3 (with bias) + BN + ReLU, NCHW
    (medseg_tpu/nn/blocks.py:148-158, reference AttentionUNet.py:15-27).
    Held as `up`, a Sequential whose parameters sit at `up.1` and `up.2`,
    the reference's keys."""

    def __init__(self, in_ch: int, features: int, dtype=torch.float32):
        super().__init__()
        self.up = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="nearest"),
            Conv2d(in_ch, features, 3, 1, 1, compute_dtype=dtype),
            BatchNorm2d(features, compute_dtype=dtype), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)


def _conv_bn_1x1(in_ch: int, features: int, dtype) -> nn.Sequential:
    return nn.Sequential(Conv2d(in_ch, features, 1, compute_dtype=dtype),
                         BatchNorm2d(features, compute_dtype=dtype))


class AttentionGate(nn.Module):
    """Additive spatial attention on a skip connection, NCHW
    (medseg_tpu/nn/blocks.py:264-319, its default unfused form; reference
    AttentionUNet.py:29-54): psi = sigmoid(BN(1x1(relu(BN(W_g g) +
    BN(W_x x))))); returns x * psi.  W_g, W_x and psi are Sequentials
    (1x1 conv with bias, BN) at the reference's `W_g.{0,1}`, `W_x.{0,1}`,
    `psi.{0,1}`.  The psi projection, a one-output-channel 1x1 conv that
    the JAX package writes as a contraction with the same parameters
    (`as_dot`), computes in the compute dtype, as everything here does."""

    def __init__(self, g_ch: int, x_ch: int, f_int: int, dtype=torch.float32):
        super().__init__()
        self.W_g = _conv_bn_1x1(g_ch, f_int, dtype)
        self.W_x = _conv_bn_1x1(x_ch, f_int, dtype)
        self.psi = _conv_bn_1x1(f_int, 1, dtype)

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        psi = torch.sigmoid(self.psi(F.relu(self.W_g(g) + self.W_x(x))))
        return x * psi


class RecurrentBlock(nn.Module):
    """Weight-tied conv recurrence, NCHW (medseg_tpu/nn/blocks.py:322-364,
    its static unroll; reference R2U_Net.py:4-20): x1 = f(x), then t times
    x1 = f(x + x1), with one f = Conv3x3 (with bias) + BN + ReLU held as
    the Sequential `conv` (`conv.0`, `conv.1`).  The one BatchNorm runs
    t+1 times a forward; in training each application blends the running
    statistics in turn, as flax's calls of one module do
    (tests/test_recurrent_scan.py)."""

    def __init__(self, features: int, t: int = 2, dtype=torch.float32):
        super().__init__()
        self.t = t
        self.conv = nn.Sequential(
            Conv2d(features, features, 3, 1, 1, compute_dtype=dtype),
            BatchNorm2d(features, compute_dtype=dtype), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv(x)
        for _ in range(self.t):
            x1 = self.conv(x + x1)
        return x1


class RRCNNBlock(nn.Module):
    """A 1x1 channel map (with bias, no BN) + two RecurrentBlocks + the
    outer residual, NCHW (medseg_tpu/nn/blocks.py:367-384, reference
    R2U_Net.py:36-48); names `conv_1x1`, `RCNN.0`, `RCNN.1`."""

    def __init__(self, in_ch: int, features: int, t: int = 2, dtype=torch.float32):
        super().__init__()
        self.RCNN = nn.Sequential(RecurrentBlock(features, t, dtype),
                                  RecurrentBlock(features, t, dtype))
        self.conv_1x1 = Conv2d(in_ch, features, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_1x1(x)
        return x + self.RCNN(x)
