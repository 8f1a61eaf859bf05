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

stem_s2d=True takes the stem's input in ops/image.py's space-to-depth
layout [B,H/2,W/2,12] (what augment_batch(s2d=True) and
preprocess_eval_batch(s2d=True) emit) and computes the same stem there
(`FoldedStem`, medseg_tpu/models/resnet.py:29-53): a 4x4 stride-1 conv
over 12 channels, refolded from the canonical conv1 weight.

`apply_with_stem_kernel` (medseg_tpu/models/resnet.py:202
`apply_with_pallas_stem`) is the inference forward through the fused stem
kernel: bn1 folded into conv1, one kernel for conv + BN + ReLU + maxpool,
and the deep stages fed through `skip_stem`.

The factories initialize as torch does, from its global generator.
`init_weights` re-initializes a model as flax does, from an explicit
generator; the trainer starts from it, so a run from scratch trains the
network the JAX package trains.  models/resnet_unet.py builds ResNetUnet
on the same trunk (`ResNetEncoder(..., unet_names=True)`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.registry import register_model
from medseg_tpu_torch.nn.blocks import (BatchNorm2d, ClassifierHead, Conv2d,
                                        global_avg_pool, max_pool)
from medseg_tpu_torch.ops.kernels.stem_kernel import fold_bn, stem_conv_pool


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _downsample(in_ch: int, out_ch: int, stride: int, dtype) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(in_ch, out_ch, 1, stride, bias=False, compute_dtype=dtype),
        BatchNorm2d(out_ch, compute_dtype=dtype))


class FoldedStem(Conv2d):
    """The 7x7/s2 stem conv evaluated on space-to-depth input: NCHW views of
    [B,H/2,W/2,12], channel c*4 + dy*2 + dx (ops/image.py space_to_depth).
    The parameter is the canonical conv1 weight [64,3,7,7] (state dict
    `conv1.weight`); each forward zero-pads it to 8x8 in front and
    refolds it, in float32, into a 4x4 stride-1 conv over 12 channels,
    cast to the compute dtype; the input is padded (2, 1) on each axis
    first, as JAX's ((2,1),(2,1)), since a conv's own padding is
    symmetric.  A cuDNN conv, as the JAX package's lax.conv."""

    def __init__(self, compute_dtype=torch.float32):
        super().__init__(3, 64, 7, 2, 3, bias=False, compute_dtype=compute_dtype)

    def folded_weight(self) -> torch.Tensor:
        w = F.pad(self.weight, (1, 0, 1, 0))  # [64, 3, 8, 8], taps 2a+d
        w = w.reshape(64, 3, 4, 2, 4, 2).permute(0, 1, 3, 5, 2, 4)
        return w.reshape(64, 12, 4, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.conv2d(F.pad(x.to(cd), (2, 1, 2, 1)), self.folded_weight().to(cd))


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
    """The convolutional trunk: NHWC images -> NHWC final feature map.

    Module names are torchvision's (`conv1`, `bn1`, `layer1`-`layer4`), or
    with unet_names=True the reference ResNetUnet's (`encoder1.0`,
    `encoder1.1` for the stem, `encoder2`-`encoder5` for the stages).
    stem_s2d: the input is in the space-to-depth layout [B,H/2,W/2,12],
    and conv1 is a FoldedStem."""

    def __init__(self, block: Type[nn.Module], stage_sizes: Sequence[int],
                 dtype=torch.float32, unet_names: bool = False, stem_s2d: bool = False):
        super().__init__()
        conv1 = (FoldedStem(dtype) if stem_s2d
                 else Conv2d(3, 64, 7, 2, 3, bias=False, compute_dtype=dtype))
        bn1 = BatchNorm2d(64, compute_dtype=dtype)
        if unet_names:
            self.encoder1 = nn.Sequential(conv1, bn1)
            self.stem_names = ("encoder1.0", "encoder1.1")
        else:
            self.conv1, self.bn1 = conv1, bn1
            self.stem_names = ("conv1", "bn1")
        self.stage_names = []
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
            name = f"encoder{stage + 2}" if unet_names else f"layer{stage + 1}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
        self.out_channels = in_ch

    def forward(self, x: torch.Tensor, skip_stem: bool = False,
                taps: bool = False):
        """skip_stem: x is already the pooled stem output [B,H/4,W/4,64]
        (from apply_with_stem_kernel); conv1/bn1 are left unused.
        taps: return the five activations ResNetUnet reads (medseg_tpu/
        models/resnet.py:116-162), all NHWC: e1, the stem's output before
        the max pool (64 channels at H/2), and the four stages' outputs."""
        if skip_stem:
            if taps:
                raise ValueError("skip_stem cannot provide the pre-pool tap e1")
            x = _nchw(x)
            feats = []
        else:
            conv, bn = map(self.get_submodule, self.stem_names)
            e1 = F.relu(bn(conv(_nchw(x))))
            x = _nchw(max_pool(_nhwc(e1), 3, 2, padding=1))
            feats = [e1]
        for name in self.stage_names:
            x = getattr(self, name)(x)
            feats.append(x)
        return [_nhwc(f) for f in feats] if taps else _nhwc(x)


class ResNetClassifier(ResNetEncoder):
    """ResNet trunk + Dropout/Linear head (reference utils/helpers.py:124-134).
    NHWC images -> float32 logits [B, num_classes]."""

    def __init__(self, block: Type[nn.Module], stage_sizes: Sequence[int],
                 num_classes: int = 3, dropout: float = 0.5,
                 dtype=torch.float32, stem_s2d: bool = False):
        super().__init__(block, stage_sizes, dtype, stem_s2d=stem_s2d)
        self.fc = ClassifierHead(self.out_channels, num_classes, dropout)

    def forward(self, x: torch.Tensor, skip_stem: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """generator: what the head's dropout draws from in training mode."""
        feats = super().forward(x, skip_stem)
        pooled = global_avg_pool(feats)  # float32, or float64 for a float64 model
        return self.fc(pooled.to(torch.promote_types(pooled.dtype, torch.float32)),
                       generator)


# The standard deviation of a unit normal truncated to (-2, 2).
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize `model` in place as flax initializes the JAX package's
    ResNet, drawing from `generator` (on the model's device):
    - Conv, ConvTranspose and Dense kernels: lecun_normal, a normal
      truncated to +-2 std with variance 1/fan_in (fan_in = in_channels *
      kh * kw, or in_features), as flax's variance_scaling computes it;
    - Conv and Dense biases 0; BatchNorm scale 1, bias 0, running mean 0,
      var 1.
    torch's default, kaiming_uniform_(a=sqrt(5)), has a sqrt(3)-smaller
    std.  The draws are not JAX's numbers; the distribution is."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # a transposed conv's weight is [in, out, kh, kw]
            fan_in = (m.weight[:, 0] if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0]).numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def apply_with_stem_kernel(model: ResNetClassifier, x: torch.Tensor,
                           planar: bool = False) -> torch.Tensor:
    """Inference forward with the fused stem kernel
    (ops/kernels/stem_kernel.py): folds bn1's running stats into conv1's
    weights in float32, casts the folded weights to the model's dtype, runs
    conv + BN + ReLU + maxpool in one kernel, and feeds the pooled map to
    the unchanged deep stages through skip_stem.

    x: [B, H, W, 3] model-input images (normalized), or the warp kernel's
    planar [B, 3H, W] layout when planar=True (the NHWC transpose never
    materializes).  H and W multiples of 4.  Eval mode only: the fold uses
    the running statistics.
    """
    if model.training:
        raise ValueError("apply_with_stem_kernel is inference-only: call "
                         "model.eval() first")
    dtype = model.conv1.compute_dtype
    bn = model.bn1
    g, b = fold_bn(bn.weight.float(), bn.bias.float(), bn.running_mean.float(),
                   bn.running_var.float(), bn.eps)
    weight = (model.conv1.weight.float() * g[:, None, None, None]).to(dtype)
    if not planar:
        bsz, h, w, c = x.shape
        x = x.permute(0, 3, 1, 2).reshape(bsz, c * h, w)
    pooled = stem_conv_pool(x.to(dtype).contiguous(), weight.contiguous(),
                            b.to(dtype))
    return model(pooled, skip_stem=True)


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
