"""Attention U-Net: a plain U-Net whose skips pass additive attention gates.

Counterpart of medseg_tpu/models/attention_unet.py:18-72 in its default
form (reference models/segmentation_models/AttentionUNet.py:56-120):
DoubleConv encoder stages 64-128-256-512-1024 with 2x2 max pools; each
decoder stage is an UpConv (nearest 2x + Conv3x3 + BN + ReLU), an
AttentionGate on the skip, the concatenation [gated skip, upsampled] and a
DoubleConv; a 1x1 conv gives one logit plane.  Module names are the
reference's (`conv1`-`conv5`, `up{5..2}.up.{1,2}`, `att{5..2}.W_g/W_x/psi`,
`up_conv{5..2}`, `out`), so a state dict from the JAX package's
`export_attention_unet` loads with strict=True.

Inputs are NHWC [B,H,W,3] with H and W multiples of 16; the output is
float32 [B,H,W,1] (float64 for a float64 model).  Convs and BN compute in
`dtype`; `out` has no dtype in flax, so it computes in dtype promoted with
float32, as ResNetUnet's does.  The JAX package's opt-in `s2d_up` and
`fused_gates` lowerings wait for ROADMAP A.16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.registry import register_model
from medseg_tpu_torch.models.resnet import _nchw, _nhwc
from medseg_tpu_torch.nn.blocks import AttentionGate, Conv2d, DoubleConv, UpConv

WIDTHS = (64, 128, 256, 512, 1024)


class AttentionUNet(nn.Module):
    def __init__(self, out_channels: int = 1, dtype=torch.float32):
        super().__init__()
        w = WIDTHS
        for i in range(5):
            self.add_module(f"conv{i + 1}",
                            DoubleConv(3 if i == 0 else w[i - 1], w[i], dtype))
        for idx in range(5, 1, -1):
            deep, skip = w[idx - 1], w[idx - 2]
            self.add_module(f"up{idx}", UpConv(deep, skip, dtype))
            self.add_module(f"att{idx}", AttentionGate(skip, skip, skip // 2, dtype))
            self.add_module(f"up_conv{idx}", DoubleConv(2 * skip, skip, dtype))
        self.out = Conv2d(w[0], out_channels, 1,
                          compute_dtype=torch.promote_types(dtype, torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x)
        feats = []
        for i in range(5):
            if i > 0:
                x = F.max_pool2d(x, 2)
            x = getattr(self, f"conv{i + 1}")(x)
            feats.append(x)
        d = feats[-1]
        for idx in range(5, 1, -1):
            d = getattr(self, f"up{idx}")(d)
            a = getattr(self, f"att{idx}")(d, feats[idx - 2])
            d = getattr(self, f"up_conv{idx}")(torch.cat([a, d], dim=1))
        return _nhwc(self.out(d))


@register_model("AttentionUNet", task="segmentation")
def attention_unet(dtype=torch.float32, device: DeviceLike = None,
                   **kw) -> AttentionUNet:
    """Randomly initialized from torch's global generator (seed it first)."""
    return AttentionUNet(dtype=dtype, **kw).to(device=resolve_device(device),
                                               memory_format=torch.channels_last)
