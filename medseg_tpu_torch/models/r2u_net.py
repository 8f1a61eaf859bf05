"""R2U-Net and R2AttU-Net: recurrent-residual U-Nets (t=5).

Counterpart of medseg_tpu/models/r2u_net.py:22-66 in its default form
(reference models/segmentation_models/R2U_Net.py:50-111 and
R2AttU_Net.py:88-157): every encoder and decoder stage is an RRCNNBlock
(a 1x1 channel map, two weight-tied Conv3x3 + BN + ReLU recurrences of t+1
applications each, the outer residual); each decoder stage upsamples with
an UpConv, optionally gates the skip (R2AttUnet), concatenates [skip,
upsampled] (the reverse of AttentionUNet's order) and runs its RRCNNBlock.
Module names are the reference's (`RRCNN{1..5}`, `up{5..2}`, `att{5..2}`,
`up_RRCNN{5..2}`, and the last 1x1 at `conv_1x1`), so a state dict from
the JAX package's `export_r2u_net` loads with strict=True.

Inputs are NHWC [B,H,W,3] with H and W multiples of 16; the output is
float32 [B,H,W,1] (float64 for a float64 model); the last 1x1 computes in
dtype promoted with float32, as flax's Conv without a dtype does.  In
training each RecurrentBlock's one BatchNorm blends its running
statistics t+1 times a forward, in order.  The opt-in lowerings of the
JAX package, each the same function with the same weights and keys:
s2d_up (decoder UpConvs as UpConvS2D, nn/s2d.py), fused_gates
(R2AttUnet's gates with fused_stats) and use_scan (accepted; the
weight-tied loop is the same, nn/blocks.py RecurrentBlock).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.registry import register_model
from medseg_tpu_torch.models.resnet import _nchw, _nhwc
from medseg_tpu_torch.nn.blocks import AttentionGate, Conv2d, RRCNNBlock, UpConv
from medseg_tpu_torch.nn.s2d import UpConvS2D

WIDTHS = (64, 128, 256, 512, 1024)


class R2UNet(nn.Module):
    def __init__(self, out_channels: int = 1, t: int = 5, attention: bool = False,
                 dtype=torch.float32, use_scan: bool = False, s2d_up: bool = False,
                 fused_gates: bool = False):
        super().__init__()
        self.attention = attention
        w = WIDTHS
        up = UpConvS2D if s2d_up else UpConv
        for i in range(5):
            self.add_module(f"RRCNN{i + 1}",
                            RRCNNBlock(3 if i == 0 else w[i - 1], w[i], t, dtype, use_scan))
        for idx in range(5, 1, -1):
            deep, skip = w[idx - 1], w[idx - 2]
            self.add_module(f"up{idx}", up(deep, skip, dtype))
            if attention:
                self.add_module(f"att{idx}",
                                AttentionGate(skip, skip, skip // 2, dtype, fused_gates))
            self.add_module(f"up_RRCNN{idx}",
                            RRCNNBlock(2 * skip, skip, t, dtype, use_scan))
        self.conv_1x1 = Conv2d(w[0], out_channels, 1,
                               compute_dtype=torch.promote_types(dtype, torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x)
        feats = []
        for i in range(5):
            if i > 0:
                x = F.max_pool2d(x, 2)
            x = getattr(self, f"RRCNN{i + 1}")(x)
            feats.append(x)
        d = feats[-1]
        for idx in range(5, 1, -1):
            d = getattr(self, f"up{idx}")(d)
            skip = feats[idx - 2]
            if self.attention:
                skip = getattr(self, f"att{idx}")(d, skip)
            d = getattr(self, f"up_RRCNN{idx}")(torch.cat([skip, d], dim=1))
        return _nhwc(self.conv_1x1(d))


def _build(attention: bool, dtype, device: DeviceLike, t: int, **kw) -> R2UNet:
    return R2UNet(t=t, attention=attention, dtype=dtype, **kw).to(
        device=resolve_device(device), memory_format=torch.channels_last)


@register_model("R2Unet", task="segmentation")
def r2u_net(dtype=torch.float32, device: DeviceLike = None, t: int = 5,
            **kw) -> R2UNet:
    """Randomly initialized from torch's global generator (seed it first)."""
    return _build(False, dtype, device, t, **kw)


@register_model("R2AttUnet", task="segmentation")
def r2attu_net(dtype=torch.float32, device: DeviceLike = None, t: int = 5,
               **kw) -> R2UNet:
    """Randomly initialized from torch's global generator (seed it first)."""
    return _build(True, dtype, device, t, **kw)
