"""ResNet-18/50 classifiers with torchvision's module names.

Counterpart of medseg_tpu/models/resnet.py:55-194: stem conv7x7/s2 + BN +
ReLU + maxpool3x3/s2, four stages of BasicBlock (18) or Bottleneck (50),
global average pool, and the reference's Dropout(0.5) + Linear(3) head at
`fc.1`.  Parameter names follow torchvision (`conv1`, `bn1`,
`layerS.I.convK`, `layerS.I.downsample.0/1`, `fc.1`), so a state dict keyed
like the JAX package's `export_resnet_classifier` loads with strict=True.

Inputs are NHWC, as in the JAX package.  Inside, the NCHW view of the NHWC
tensor is channels_last memory, which cuDNN takes without a copy.
Parameters and BN statistics are float32; convs and BN compute in `dtype`;
the pooled features and the head are float32.
"""

from __future__ import annotations

import functools
from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.registry import register_model
from medseg_tpu_torch.nn.blocks import (BatchNorm2d, ClassifierHead, Conv2d,
                                        global_avg_pool, max_pool)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _downsample(in_ch: int, out_ch: int, stride: int, dtype) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(in_ch, out_ch, 1, stride, bias=False, compute_dtype=dtype),
        BatchNorm2d(out_ch, compute_dtype=dtype))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        conv = functools.partial(Conv2d, bias=False, compute_dtype=dtype)
        self.conv1 = conv(in_ch, features, 3, stride, 1)
        self.bn1 = BatchNorm2d(features, compute_dtype=dtype)
        self.conv2 = conv(features, features, 3, 1, 1)
        self.bn2 = BatchNorm2d(features, compute_dtype=dtype)
        self.downsample = (_downsample(in_ch, features, stride, dtype)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4  # output channels = 4 * features

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        conv = functools.partial(Conv2d, bias=False, compute_dtype=dtype)
        out_ch = features * self.expansion
        self.conv1 = conv(in_ch, features, 1)
        self.bn1 = BatchNorm2d(features, compute_dtype=dtype)
        # torchvision places the stride on the 3x3 conv.
        self.conv2 = conv(features, features, 3, stride, 1)
        self.bn2 = BatchNorm2d(features, compute_dtype=dtype)
        self.conv3 = conv(features, out_ch, 1)
        self.bn3 = BatchNorm2d(out_ch, compute_dtype=dtype)
        self.downsample = (_downsample(in_ch, out_ch, stride, dtype)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetEncoder(nn.Module):
    """The convolutional trunk: NHWC images -> NHWC final feature map."""

    def __init__(self, block: Type[nn.Module], stage_sizes: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(64, compute_dtype=dtype)
        in_ch = 64
        for stage, (n_blocks, width) in enumerate(zip(stage_sizes,
                                                      (64, 128, 256, 512))):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (i == 0 and stage > 0) else 1
                out_ch = width * block.expansion
                down = i == 0 and (stride != 1 or in_ch != out_ch)
                blocks.append(block(in_ch, width, stride, down, dtype))
                in_ch = out_ch
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.out_channels = in_ch
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(_nchw(x))))
        x = _nchw(max_pool(_nhwc(x), 3, 2, padding=1))
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return _nhwc(x)


class ResNetClassifier(ResNetEncoder):
    """ResNet trunk + Dropout/Linear head (reference utils/helpers.py:124-134).
    NHWC images -> float32 logits [B, num_classes]."""

    def __init__(self, block: Type[nn.Module], stage_sizes: Sequence[int],
                 num_classes: int = 3, dropout: float = 0.5,
                 dtype=torch.float32):
        super().__init__(block, stage_sizes, dtype)
        self.fc = ClassifierHead(self.out_channels, num_classes, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = super().forward(x)
        return self.fc(global_avg_pool(feats).to(torch.float32))


def _build(block, stage_sizes, num_classes, dtype, device, **kw):
    model = ResNetClassifier(block, stage_sizes, num_classes=num_classes,
                             dtype=dtype, **kw)
    return model.to(device=resolve_device(device),
                    memory_format=torch.channels_last)


@register_model("ResNet18", task="classification")
def resnet18(num_classes: int = 3, dtype=torch.float32,
             device: DeviceLike = None, **kw) -> ResNetClassifier:
    """Randomly initialized from torch's global generator (seed it first)."""
    return _build(BasicBlock, (2, 2, 2, 2), num_classes, dtype, device, **kw)


@register_model("ResNet50", task="classification")
def resnet50(num_classes: int = 3, dtype=torch.float32,
             device: DeviceLike = None, **kw) -> ResNetClassifier:
    """Randomly initialized from torch's global generator (seed it first)."""
    return _build(Bottleneck, (3, 4, 6, 3), num_classes, dtype, device, **kw)
