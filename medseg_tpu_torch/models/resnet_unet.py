"""ResNetUnet: a ResNet-50 encoder and a transposed-conv decoder with skip
concatenations, for one-plane segmentation.

Counterpart of medseg_tpu/models/resnet_unet.py:50-108 (reference
models/segmentation_models/ResnetUnet.py:17-83).  The encoder is the port's
ResNet trunk (models/resnet.py) under the reference's names and returns
five taps: the stem's output before the max pool (e1, H/2) and the four
stages' outputs.  Each decoder block upsamples the deep path with a k2/s2
ConvTranspose, concatenates the skip and runs a DoubleConv; a last
ConvTranspose(64->32) + Conv3x3 + BN + ReLU and a 1x1 conv give one logit
plane at full resolution.  Module names are the reference's
(`encoder1.0/1`, `encoder2`-`encoder5`, `decoder{5..2}.up_sample`,
`decoder{i}.basic_block.*`, `decoder1.{0,1,2}`, `out`), so a state dict from
the JAX package's `export_resnet_unet` loads with strict=True.

Inputs are NHWC, as in the JAX package; the output is float32 [B,H,W,1]
(float64 for a float64 model).  Convs, transposed convs and BN compute in
`dtype`; the 1x1 `out` conv computes in dtype promoted with float32, as
flax's Conv without a dtype promotes its input to its float32 kernel.
The encoder is frozen in training by the optimizer's parameter set
(train/freeze.py finetune_filter), not by the module.  The transposed convs
are cuDNN's: the JAX package computes them with XLA outside any Pallas
kernel.  up_as_dot=True lowers all five as `ConvT2x2AsDot`: one
[Ci, 4*Co] contraction (cuBLAS) and a depth-to-space, with the same
weights and keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.registry import register_model
from medseg_tpu_torch.models.resnet import Bottleneck, ResNetEncoder, _nchw, _nhwc
from medseg_tpu_torch.nn.blocks import (BatchNorm2d, Conv2d, ConvTranspose2d,
                                        DoubleConv)
from medseg_tpu_torch.nn.s2d import depth_to_space


class ConvT2x2AsDot(ConvTranspose2d):
    """ConvTranspose2d(k=2, s=2) lowered as a channel contraction to
    4*Co sub-position channels followed by depth-to-space
    (medseg_tpu/models/resnet_unet.py:23-47).  Each output pixel comes
    from one input pixel: out[2i+dy, 2j+dx] = x[i,j] @ W[:, :, dy, dx] + b,
    with torch's weight [Ci, Co, 2, 2] read unflipped (flax's
    ConvTranspose is flipped against torch's, so the JAX twin reads
    kernel[::-1, ::-1]).  The same parameters and keys; NCHW in and out."""

    def __init__(self, in_ch: int, out_ch: int, compute_dtype=torch.float32):
        super().__init__(in_ch, out_ch, 2, 2, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        ci, co = self.weight.shape[:2]
        a = self.weight.permute(2, 3, 1, 0).reshape(4 * co, ci)  # row (dy*2+dx)*Co + co
        y = F.linear(_nhwc(x).to(cd), a.to(cd), self.bias.repeat(4).to(cd))
        return _nchw(depth_to_space(y))


def _up(in_ch: int, out_ch: int, dtype, as_dot: bool) -> nn.Module:
    if as_dot:
        return ConvT2x2AsDot(in_ch, out_ch, dtype)
    return ConvTranspose2d(in_ch, out_ch, 2, 2, compute_dtype=dtype)


class DecoderBlock(nn.Module):
    """ConvTranspose 2x on the deep path (its channels kept), concat the
    skip, DoubleConv (reference ResnetUnet.py:17-27).  NCHW."""

    def __init__(self, deep_ch: int, skip_ch: int, features: int,
                 dtype=torch.float32, up_as_dot: bool = False):
        super().__init__()
        self.up_sample = _up(deep_ch, deep_ch, dtype, up_as_dot)
        self.basic_block = DoubleConv(deep_ch + skip_ch, features, dtype)

    def forward(self, down: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.basic_block(torch.cat([self.up_sample(down), skip], dim=1))


class ResNetUnet(ResNetEncoder):
    """NHWC images [B,H,W,3] (H, W multiples of 32) -> float32 logits
    [B,H,W,n_classes]; a float64 model keeps float64 throughout."""

    def __init__(self, n_classes: int = 1, dtype=torch.float32, up_as_dot: bool = False):
        super().__init__(Bottleneck, (3, 4, 6, 3), dtype, unet_names=True)
        self.decoder5 = DecoderBlock(2048, 1024, 1024, dtype, up_as_dot)
        self.decoder4 = DecoderBlock(1024, 512, 512, dtype, up_as_dot)
        self.decoder3 = DecoderBlock(512, 256, 256, dtype, up_as_dot)
        self.decoder2 = DecoderBlock(256, 64, 64, dtype, up_as_dot)
        self.decoder1 = nn.Sequential(
            _up(64, 32, dtype, up_as_dot),
            Conv2d(32, 32, 3, 1, 1, compute_dtype=dtype),
            BatchNorm2d(32, compute_dtype=dtype), nn.ReLU())
        self.out = Conv2d(32, n_classes, 1,
                          compute_dtype=torch.promote_types(dtype, torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1, e2, e3, e4, e5 = map(_nchw, super().forward(x, taps=True))
        d = self.decoder5(e5, e4)
        d = self.decoder4(d, e3)
        d = self.decoder3(d, e2)
        d = self.decoder2(d, e1)
        return _nhwc(self.out(self.decoder1(d)))


@register_model("ResNetUnet", task="segmentation", encoder_frozen=True)
def resnet_unet(dtype=torch.float32, device: DeviceLike = None, **kw) -> ResNetUnet:
    """Randomly initialized from torch's global generator (seed it first)."""
    return ResNetUnet(dtype=dtype, **kw).to(device=resolve_device(device),
                                            memory_format=torch.channels_last)
