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

from medseg_tpu_torch.parallel.sharding import current_group, global_rows, local_rows


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
    (the momentum is fixed).

    Under data parallelism (training mode inside `parallel.data_parallel(
    group)`, world 1 too) the statistics are the global batch's, as XLA's
    BatchNorm over a sharded batch: per channel, the sums of x and x^2 and
    the count in float32 (float64 for a float64 input), one packed
    all-reduce, then mean = sum/n and var = max(sum_sq/n - mean^2, 0),
    flax's fast variance (`_compute_stats`, use_fast_variance=True).  Its
    backward all-reduces [sum dy, sum dy*xhat] in one packed tensor and
    keeps the weight and bias gradients local (the train step averages
    them).  torch.nn.SyncBatchNorm is not used: its forward refuses CPU
    tensors, and it blends the unbiased variance."""

    def __init__(self, *args, compute_dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if not self.training:
            return super().forward(x)
        group = current_group()
        if group is not None:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps,
                                                  group)
        else:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            var = invstd.pow(-2) - self.eps
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
        return y


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm over the global batch of a data-parallel
    group: (y, mean, biased var); one all-reduce each way."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group):
        acc = torch.float64 if x.dtype == torch.float64 else torch.float32
        xf = x.to(acc)
        c = x.shape[1]
        stats = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                           torch.full((1,), x.numel() // c, dtype=acc, device=x.device)])
        group.all_reduce_(stats)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - _per_channel(mean)) * _per_channel(invstd)
        y = xhat * _per_channel(weight.to(acc)) + _per_channel(bias.to(acc))
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dyf = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - _per_channel(mean)) * _per_channel(invstd)
        sums = torch.cat([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        dweight = sums[c:].to(weight.dtype) if ctx.needs_input_grad[1] else None
        dbias = sums[:c].to(weight.dtype) if ctx.needs_input_grad[2] else None
        dx = None
        if ctx.needs_input_grad[0]:  # the weight and bias keep this rank's sums
            total = ctx.group.all_reduce_(sums.clone())
            dx = ((dyf - _per_channel(total[:c] / n) - xhat * _per_channel(total[c:] / n))
                  * _per_channel(invstd * weight.to(mean.dtype))).to(x.dtype)
        return dx, dweight, dbias, None, None


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
    drawn from `generator`, and scale the kept ones by 1/(1-p).  Under data
    parallelism the mask is drawn for the global batch and each rank keeps
    its rows, so W ranks draw what one process draws."""
    shape = (global_rows(x.shape[0]),) + tuple(x.shape[1:])
    keep = local_rows(torch.rand(shape, generator=generator, device=x.device)) < 1.0 - p
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
