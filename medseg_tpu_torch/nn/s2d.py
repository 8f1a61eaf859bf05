"""Space-to-depth lowerings of the U-Nets' full-resolution blocks.

Counterpart of medseg_tpu/nn/s2d.py.  Each twin computes the same function
as its default block, with the same parameters under the same state-dict
keys, on a half-resolution grid with four times the channels:

- `UpConvS2D` (nearest 2x upsample + Conv3x3 + BN + ReLU, the U-Nets'
  `up`): the four output sub-positions of one upsampled 2x2 cell read the
  same input pixels, so s2d(conv3x3(nearest2x(x))) = conv3x3(x, W') with
  W' [4*Co, Ci, 3, 3] summing the taps that alias each (sub-position,
  offset) cell: no extra multiply-adds, and the conv runs on the grid
  before the upsample.
- `DoubleConvS2D` (two Conv3x3 + BN + ReLU on an s2d tensor): exact, but
  the dense kernel [4*Co, 4*Ci, 3, 3] holds each tap once per output
  sub-position, four times the multiply-adds.

The channel order of an s2d tensor here is the JAX package's,
(dy*2+dx)*C + c, sub-position major (`space_to_depth`); ops/image.py's
stem layout, c*4 + dy*2 + dx, is another and stays separate.  The kernel
re-layouts take and return the JAX layout [3,3,Ci,Co] (`*_kernel`) or
torch's [Co,Ci,3,3] (`*_weight`); both are gathers and adds of the
original weight, applied at every forward, so the gradient reaches the
weight as the re-layout's transpose.  Aliased taps are summed in the JAX
package's order, so the re-laid kernels equal its own bit for bit.

BatchNorm over an s2d tensor reduces, per logical channel, over (batch,
H, W, sub-position): the element set of the full-resolution BatchNorm.
In NHWC memory with the sub-position-major order, [B,H,W,4C] is
[B,H,4W,C], so the block's own `BatchNorm2d` normalizes that view: the
statistics `_grouped_bn_stats` states (up to the variance formula:
ATen's against flax's fast one), its running statistics blended once a
forward as every port BatchNorm blends them, the global batch's under
data parallelism.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from medseg_tpu_torch.nn.blocks import BatchNorm2d, Conv2d, DoubleConv, UpConv
from medseg_tpu_torch.ops.image import host_to_device

_ZERO_TAP = 9  # the index of the zero row appended to the 9 taps


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, 2H, 2W, C] -> [B, H, W, 4C]; channel (dy*2+dx)*C + c."""
    b, h2, w2, c = x.shape
    h, w = h2 // 2, w2 // 2
    return x.reshape(b, h, 2, w, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, 4 * c)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """Inverse of space_to_depth: [B, H, W, 4C] -> [B, 2H, 2W, C]."""
    b, h, w, c4 = y.shape
    c = c4 // 4
    return y.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)


def _upconv_taps() -> np.ndarray:
    """[a, b, sub, slot] -> tap ky*3+kx: the taps that alias s2d cell
    (a, b) of output sub-position sub, in the JAX package's loop order,
    padded with _ZERO_TAP."""
    taps = [[[[] for _ in range(4)] for _ in range(3)] for _ in range(3)]
    for dy in range(2):
        for dx in range(2):
            for ky in range(3):
                for kx in range(3):
                    a = (dy + ky - 1) // 2 + 1
                    b = (dx + kx - 1) // 2 + 1
                    taps[a][b][dy * 2 + dx].append(ky * 3 + kx)
    out = np.full((3, 3, 4, 4), _ZERO_TAP, np.int64)
    for a in range(3):
        for b in range(3):
            for sub in range(4):
                out[a, b, sub, :len(taps[a][b][sub])] = taps[a][b][sub]
    return out


def _conv3x3_taps() -> np.ndarray:
    """[a, b, input sub, output sub] -> tap ky*3+kx (or _ZERO_TAP): output
    sub-position dy at s2d pixel i reads input sub-position dy' of pixel
    i+a where ky = 2a + dy' - dy + 1."""
    idx = [(d, a, dp, 2 * a + dp - d + 1)
           for d in range(2) for a in (-1, 0, 1) for dp in range(2)
           if 0 <= 2 * a + dp - d + 1 <= 2]
    out = np.full((3, 3, 4, 4), _ZERO_TAP, np.int64)
    for dy, a, dyp, ky in idx:
        for dx, b, dxp, kx in idx:
            out[a + 1, b + 1, dyp * 2 + dxp, dy * 2 + dx] = ky * 3 + kx
    return out


_TAPS = {"up": _upconv_taps(), "conv3x3": _conv3x3_taps()}


@functools.lru_cache(maxsize=None)
def _taps(kind: str, device: torch.device) -> torch.Tensor:
    """The tap table on `device`, copied there once per process."""
    return host_to_device(_TAPS[kind], device)


def _padded_taps(kernel: torch.Tensor) -> torch.Tensor:
    """[3,3,Ci,Co] -> [10,Ci,Co]: the nine taps and a zero row."""
    k = kernel.reshape(9, *kernel.shape[2:])
    return torch.cat([k, k.new_zeros(1, *k.shape[1:])])


def upconv_s2d_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """[3,3,Ci,Co] conv kernel (applied after nearest 2x) -> the s2d-domain
    kernel [3,3,Ci,4*Co].  Output sub-position (dy,dx) at s2d pixel (i,j)
    reads x[i+a, j+b] with a = floor((dy+ky-1)/2); the taps that alias one
    (a, b) cell are summed, in (ky, kx) order from zero."""
    ci, co = kernel.shape[2], kernel.shape[3]
    k = _padded_taps(kernel)
    idx = _taps("up", kernel.device)
    out = k[idx[..., 0]]  # [3,3,4,Ci,Co]
    for slot in range(1, 4):
        out = out + k[idx[..., slot]]
    return out.permute(0, 1, 3, 2, 4).reshape(3, 3, ci, 4 * co)


def conv3x3_s2d_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """[3,3,Ci,Co] stride-1 same-padding conv kernel -> the s2d-domain
    kernel [3,3,4*Ci,4*Co] (dense: each tap once per output sub-position)."""
    ci, co = kernel.shape[2], kernel.shape[3]
    out = _padded_taps(kernel)[_taps("conv3x3", kernel.device)]  # [3,3,4,4,Ci,Co]
    return out.permute(0, 1, 2, 4, 3, 5).reshape(3, 3, 4 * ci, 4 * co)


def upconv_s2d_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch's form of upconv_s2d_kernel: [Co,Ci,3,3] -> [4*Co,Ci,3,3]."""
    return upconv_s2d_kernel(weight.permute(2, 3, 1, 0)).permute(3, 2, 0, 1)


def conv3x3_s2d_weight(weight: torch.Tensor) -> torch.Tensor:
    """torch's form of conv3x3_s2d_kernel: [Co,Ci,3,3] -> [4*Co,4*Ci,3,3]."""
    return conv3x3_s2d_kernel(weight.permute(2, 3, 1, 0)).permute(3, 2, 0, 1)


def _grouped_bn_stats(y_s2d: torch.Tensor, features: int):
    """Per-logical-channel batch mean and variance of an s2d tensor
    [..., 4*C]: over (batch, H, W, sub-position) in float32 (float64 for
    a float64 input), flax's E[x^2] - E[x]^2 clipped at 0."""
    acc = torch.promote_types(y_s2d.dtype, torch.float32)
    y = y_s2d.to(acc).reshape(-1, 4, features)
    mean = y.mean(dim=(0, 1))
    var = torch.clamp((y * y).mean(dim=(0, 1)) - mean * mean, min=0.0)
    return mean, var


def _s2d_conv_bn_relu(x: torch.Tensor, conv: Conv2d, bn: BatchNorm2d,
                      relayout) -> torch.Tensor:
    """conv's 3x3 conv with its weight re-laid by `relayout`, then bn and
    ReLU, on an s2d tensor (NCHW view [B, 4*Ci or Ci, H, W]); returns the
    NCHW view [B, 4*Co, H, W], channels_last memory."""
    cd = conv.compute_dtype
    y = F.conv2d(x.to(cd), relayout(conv.weight).to(cd), conv.bias.repeat(4).to(cd),
                 padding=1)
    b, c4, h, w = y.shape
    y = y.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    # [B,H,W,4C] in sub-position-major order is [B,H,4W,C]: BatchNorm's
    # per-channel reduction runs over (batch, H, W, sub-position)
    y = F.relu(bn(y.reshape(b, h, 4 * w, c4 // 4).permute(0, 3, 1, 2)))
    return y.permute(0, 2, 3, 1).reshape(b, h, w, c4).permute(0, 3, 1, 2)


def _nchw_depth_to_space(y: torch.Tensor) -> torch.Tensor:
    return depth_to_space(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class UpConvS2D(UpConv):
    """UpConv (nearest 2x + Conv3x3 + BN + ReLU) computed on the grid
    before the upsample: NCHW [B,Ci,H,W] -> [B,F,2H,2W], or the s2d
    layout [B,4F,H,W] with keep_s2d=True.  Its state dict is UpConv's
    (`up.1`, `up.2`)."""

    def forward(self, x: torch.Tensor, keep_s2d: bool = False) -> torch.Tensor:
        y = _s2d_conv_bn_relu(x, self.up[1], self.up[2], upconv_s2d_weight)
        return y if keep_s2d else _nchw_depth_to_space(y)


class DoubleConvS2D(DoubleConv):
    """DoubleConv computed in the s2d domain (four times the multiply-adds):
    NCHW [B,Ci,2H,2W] -> [B,F,2H,2W], or [B,4F,H,W] with keep_s2d=True.
    Its state dict is DoubleConv's (indices 0, 1, 3, 4)."""

    def forward(self, x: torch.Tensor, keep_s2d: bool = False) -> torch.Tensor:
        xs = space_to_depth(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        xs = _s2d_conv_bn_relu(xs, self[0], self[1], conv3x3_s2d_weight)
        xs = _s2d_conv_bn_relu(xs, self[3], self[4], conv3x3_s2d_weight)
        return xs if keep_s2d else _nchw_depth_to_space(xs)
