"""Plain PyTorch ResNet-18 and ResNetUnet: the benchmark's reference models.

Written from the published architectures (He et al. 2016, torchvision's
module names; U-Net's decoder of Ronneberger et al. 2015 on a ResNet-50
encoder, under the names of the medical-segmentation project the port
follows), with nothing of the program under test: plain `nn.Conv2d`,
`nn.ConvTranspose2d`, `nn.Linear` and `F.batch_norm`.  Inputs are NHWC
[B, H, W, 3], as the program takes them.  The state-dict keys are the
program's, so one dict of weights made by the benchmark loads into both.

Training-mode BatchNorm normalizes with the batch's biased variance (the
running statistics are not updated: no compared number reads them).  The
operands and output of every conv and transposed conv, and the output of
every BatchNorm, go through `quant`: the identity for the float32
reference, a rounding to a lower precision for the control
(reference/precision.py).  The head and the segmenter's 1x1 output conv
stay float32, as in the program.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Quant = Callable[[torch.Tensor], torch.Tensor]


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


class QConv(nn.Conv2d):
    quant: Quant = staticmethod(_identity)

    def forward(self, x):
        q = self.quant
        return q(self._conv_forward(q(x), q(self.weight), self.bias))


class QConvT(nn.ConvTranspose2d):
    quant: Quant = staticmethod(_identity)

    def forward(self, x):
        q = self.quant
        return q(F.conv_transpose2d(q(x), q(self.weight), self.bias, self.stride, self.padding))


class BN(nn.BatchNorm2d):
    """Batch statistics (biased variance) in training, running ones in eval."""
    quant: Quant = staticmethod(_identity)

    def forward(self, x):
        if self.training:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        else:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
        return self.quant(y)


def _conv(cin, cout, k, stride=1, pad=0, bias=False):
    return QConv(cin, cout, k, stride, pad, bias=bias)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, width, stride, down):
        super().__init__()
        self.conv1 = _conv(cin, width, 3, stride, 1)
        self.bn1 = BN(width)
        self.conv2 = _conv(width, width, 3, 1, 1)
        self.bn2 = BN(width)
        self.downsample = (nn.Sequential(_conv(cin, width, 1, stride), BN(width))
                           if down else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride, down):
        super().__init__()
        cout = width * 4
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = BN(width)
        self.conv2 = _conv(width, width, 3, stride, 1)  # the stride on the 3x3 (torchvision)
        self.bn2 = BN(width)
        self.conv3 = _conv(width, cout, 1)
        self.bn3 = BN(cout)
        self.downsample = (nn.Sequential(_conv(cin, cout, 1, stride), BN(cout))
                           if down else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


def _stages(module: nn.Module, block, stage_sizes: Sequence[int], widths: Sequence[int],
            names: Sequence[str]) -> None:
    cin = widths[0]
    for n_blocks, width, name in zip(stage_sizes, widths, names):
        blocks = []
        for i in range(n_blocks):
            stride = 2 if i == 0 and name != names[0] else 1
            cout = width * block.expansion
            blocks.append(block(cin, width, stride, i == 0 and (stride != 1 or cin != cout)))
            cin = cout
        module.add_module(name, nn.Sequential(*blocks))


class ResNetClassifier(nn.Module):
    """conv7x7/s2 + BN + ReLU + maxpool3x3/s2, four stages, global average
    pool, Dropout + Linear head at `fc.1` (the project's transfer head)."""

    def __init__(self, block: str, stage_sizes, widths, num_classes: int, dropout: float):
        super().__init__()
        blk = BLOCKS[block]
        self.conv1 = _conv(3, widths[0], 7, 2, 3)
        self.bn1 = BN(widths[0])
        self.stage_names = ("layer1", "layer2", "layer3", "layer4")
        _stages(self, blk, stage_sizes, widths, self.stage_names)
        self.fc = nn.Sequential(nn.Dropout(dropout),
                                nn.Linear(widths[-1] * blk.expansion, num_classes))

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: NHWC float; keep: the dropout's kept-mask [B, features] in
        training (the head scales kept values by 1/(1-p)), None in eval."""
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for name in self.stage_names:
            x = getattr(self, name)(x)
        feats = x.mean(dim=(2, 3))
        if keep is not None:
            p = self.fc[0].p
            feats = torch.where(keep, feats / (1.0 - p), 0.0)
        return self.fc[1](feats)


class DoubleConv(nn.Sequential):
    def __init__(self, cin, features):
        super().__init__(_conv(cin, features, 3, 1, 1, bias=True), BN(features), nn.ReLU(),
                         _conv(features, features, 3, 1, 1, bias=True), BN(features), nn.ReLU())


class DecoderBlock(nn.Module):
    def __init__(self, deep, skip, features):
        super().__init__()
        self.up_sample = QConvT(deep, deep, 2, 2)
        self.basic_block = DoubleConv(deep + skip, features)

    def forward(self, down, skip):
        return self.basic_block(torch.cat([self.up_sample(down), skip], dim=1))


class ResNetUnet(nn.Module):
    """ResNet-50 encoder (names encoder1.0/1 for the stem, encoder2-5 for
    the stages) with taps at the stem's pre-pool output and each stage, four
    decoder blocks (k2/s2 ConvTranspose, concat, DoubleConv), a last
    ConvTranspose(64->32) + Conv3x3 + BN + ReLU and a 1x1 conv to one
    logit plane.  NHWC in, NHWC [B, H, W, 1] out."""

    def __init__(self, stage_sizes, widths, decoder, n_classes: int = 1):
        super().__init__()
        self.encoder1 = nn.Sequential(_conv(3, widths[0], 7, 2, 3), BN(widths[0]))
        self.stage_names = ("encoder2", "encoder3", "encoder4", "encoder5")
        _stages(self, Bottleneck, stage_sizes, widths, self.stage_names)
        for i, (deep, skip, feats) in zip((5, 4, 3, 2), decoder):
            self.add_module(f"decoder{i}", DecoderBlock(deep, skip, feats))
        last = decoder[-1][2]
        self.decoder1 = nn.Sequential(QConvT(last, last // 2, 2, 2),
                                      _conv(last // 2, last // 2, 3, 1, 1, bias=True),
                                      BN(last // 2), nn.ReLU())
        self.out = nn.Conv2d(last // 2, n_classes, 1)  # float32 in the program too

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        e1 = F.relu(self.encoder1(x))
        feats = [e1]
        x = F.max_pool2d(e1, 3, 2, 1)
        for name in self.stage_names:
            x = getattr(self, name)(x)
            feats.append(x)
        e1, e2, e3, e4, e5 = feats
        d = self.decoder5(e5, e4)
        d = self.decoder4(d, e3)
        d = self.decoder3(d, e2)
        d = self.decoder2(d, e1)
        return self.out(self.decoder1(d)).permute(0, 2, 3, 1)


def build(config: dict, device="cpu") -> nn.Module:
    """The reference model of a benchmark configuration (configs/*.json)."""
    arch = config["architecture"]
    kind = arch["kind"]
    with torch.device(device):
        if kind == "resnet_classifier":
            return ResNetClassifier(arch["block"], arch["stage_sizes"], arch["widths"],
                                    arch["num_classes"], arch["dropout"])
        if kind == "resnet_unet":
            return ResNetUnet(arch["stage_sizes"], arch["widths"],
                              [tuple(d) for d in arch["decoder"]], arch["num_classes"])
    raise ValueError(f"no reference model of kind {kind!r}")


def set_quant(model: nn.Module, quant: Quant) -> None:
    """Round at every point where the program rounds to its compute dtype:
    each conv's operands and output, each BatchNorm's output (per instance)."""
    for m in model.modules():
        if isinstance(m, (QConv, QConvT, BN)):
            m.quant = quant
