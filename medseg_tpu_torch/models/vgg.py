"""VGG16-BN and VGG19-BN classifiers with torchvision's module names.

Counterpart of medseg_tpu/models/vgg.py:29-86 (the reference loads
torchvision's vgg16_bn/vgg19_bn and swaps the last Linear for
Dropout(0.5) + Linear(3), utils/helpers.py:135-144): `features` holds
Conv3x3 (with bias) + BN + ReLU per conv and a 2x2 max pool per stage
(2-2-3-3-3 for VGG16, 2-2-4-4-4 for VGG19), at torchvision's indices; an
adaptive average pool to 7x7 (the identity at 224px, overlapping bins from
8x8 at 256px, in float32); a flatten in CHW order; and `classifier`, the
sequence [Linear, ReLU, Dropout, Linear, ReLU, Dropout, Dropout, Linear]
whose Linears sit at `classifier.0`, `.3` and `.7`.  A state dict from the
JAX package's `export_vgg_classifier` loads with strict=True.

Inputs are NHWC [B,H,W,3] with H and W multiples of 32.  Convs, BN and the
three Linears compute in `dtype` (the JAX package's Dense(dtype=...)); the
logits are float32 (float64 for a float64 model).  In training the three
dropouts draw, in order, from the explicit `generator` that
train/steps.cls_train_step passes, never from torch's global RNG; their
rates are the nn.Dropout modules' `p` (0.5, 0.5 and `dropout`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.registry import register_model
from medseg_tpu_torch.models.resnet import _nchw, _nhwc
from medseg_tpu_torch.nn.blocks import (BatchNorm2d, Conv2d, Linear, adaptive_avg_pool,
                                        dropout)

VGG16_STAGES = (2, 2, 3, 3, 3)
VGG19_STAGES = (2, 2, 4, 4, 4)
STAGE_WIDTHS = (64, 128, 256, 512, 512)


def _vgg_feature_indices(stages: Sequence[int]):
    """torchvision features.Sequential indices (conv, bn) of each conv, per
    stage (a copy of medseg_tpu/interop/torch_cnn.py:82-93)."""
    idx = 0
    table = []
    for n_convs in stages:
        stage = []
        for _ in range(n_convs):
            stage.append((idx, idx + 1))
            idx += 3  # conv, bn, relu
        idx += 1  # maxpool
        table.append(stage)
    return table


class VGGClassifier(nn.Module):
    """NHWC images -> logits [B, num_classes]."""

    def __init__(self, stages: Sequence[int], num_classes: int = 3,
                 dropout: float = 0.5, dtype=torch.float32):
        super().__init__()
        layers, in_ch = [], 3
        for n_convs, width in zip(stages, STAGE_WIDTHS):
            for _ in range(n_convs):
                layers += [Conv2d(in_ch, width, 3, 1, 1, compute_dtype=dtype),
                           BatchNorm2d(width, compute_dtype=dtype), nn.ReLU()]
                in_ch = width
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            Linear(512 * 7 * 7, 4096, compute_dtype=dtype), nn.ReLU(), nn.Dropout(0.5),
            Linear(4096, 4096, compute_dtype=dtype), nn.ReLU(), nn.Dropout(0.5),
            nn.Dropout(dropout), Linear(4096, num_classes, compute_dtype=dtype))
        self.logits_dtype = torch.promote_types(dtype, torch.float32)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """generator: what the dropouts draw from in training mode."""
        x = adaptive_avg_pool(_nhwc(self.features(_nchw(x))), 7, 7)
        x = x.permute(0, 3, 1, 2).flatten(1)  # torch's CHW order
        for m in self.classifier:
            if isinstance(m, nn.Dropout):
                if self.training and m.p > 0.0:
                    if generator is None:
                        raise ValueError("training-mode dropout draws from an "
                                         "explicit torch.Generator: pass generator=")
                    x = dropout(x, m.p, generator)
            else:
                x = m(x)
        return x.to(self.logits_dtype)


def _build(stages, num_classes, dtype, device, **kw) -> VGGClassifier:
    model = VGGClassifier(stages, num_classes=num_classes, dtype=dtype, **kw)
    return model.to(device=resolve_device(device), memory_format=torch.channels_last)


@register_model("VGG16", task="classification")
def vgg16(num_classes: int = 3, dtype=torch.float32, device: DeviceLike = None,
          **kw) -> VGGClassifier:
    """Randomly initialized from torch's global generator (seed it first)."""
    return _build(VGG16_STAGES, num_classes, dtype, device, **kw)


@register_model("VGG19", task="classification")
def vgg19(num_classes: int = 3, dtype=torch.float32, device: DeviceLike = None,
          **kw) -> VGGClassifier:
    """Randomly initialized from torch's global generator (seed it first)."""
    return _build(VGG19_STAGES, num_classes, dtype, device, **kw)
