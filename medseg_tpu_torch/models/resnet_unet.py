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
kernel.  Its opt-in `up_as_dot` lowering waits for ROADMAP A.16.
"""

from __future__ import annotations

import torch
from torch import nn

from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.registry import register_model
from medseg_tpu_torch.models.resnet import Bottleneck, ResNetEncoder, _nchw, _nhwc
from medseg_tpu_torch.nn.blocks import (BatchNorm2d, Conv2d, ConvTranspose2d,
                                        DoubleConv)


class DecoderBlock(nn.Module):
    """ConvTranspose 2x on the deep path (its channels kept), concat the
    skip, DoubleConv (reference ResnetUnet.py:17-27).  NCHW."""

    def __init__(self, deep_ch: int, skip_ch: int, features: int,
                 dtype=torch.float32):
        super().__init__()
        self.up_sample = ConvTranspose2d(deep_ch, deep_ch, 2, 2, compute_dtype=dtype)
        self.basic_block = DoubleConv(deep_ch + skip_ch, features, dtype)

    def forward(self, down: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.basic_block(torch.cat([self.up_sample(down), skip], dim=1))


class ResNetUnet(ResNetEncoder):
    """NHWC images [B,H,W,3] (H, W multiples of 32) -> float32 logits
    [B,H,W,n_classes]; a float64 model keeps float64 throughout."""

    def __init__(self, n_classes: int = 1, dtype=torch.float32):
        super().__init__(Bottleneck, (3, 4, 6, 3), dtype, unet_names=True)
        self.decoder5 = DecoderBlock(2048, 1024, 1024, dtype)
        self.decoder4 = DecoderBlock(1024, 512, 512, dtype)
        self.decoder3 = DecoderBlock(512, 256, 256, dtype)
        self.decoder2 = DecoderBlock(256, 64, 64, dtype)
        self.decoder1 = nn.Sequential(
            ConvTranspose2d(64, 32, 2, 2, compute_dtype=dtype),
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
