"""Model FLOPs from shapes: what the MFU metrics count.

Each conv, transposed conv and linear layer of a configuration's
architecture (configs/*.json `architecture`) is listed with its
multiply-adds for one image and two flags: whether its weight trains, and
whether the gradient flows into its input.  A forward is 2 flops a
multiply-add; training adds the weight's gradient (another 2) for a
trainable layer and the input's (another 2) where the gradient flows
there, so a frozen encoder counts its forward only, and the first conv of
a classifier computes no gradient of the image.  BatchNorm, activations,
pooling, the loss and the optimizer are left out (a few percent of the
operations, none on the tensor cores); nothing is recomputed.
"""

from __future__ import annotations

from typing import List, NamedTuple


class Layer(NamedTuple):
    name: str
    macs: int        # multiply-adds for one image's forward
    trainable: bool
    grad_input: bool


def _conv(name, h, w, cin, cout, k, stride, trainable, grad_input):
    oh, ow = -(-h // stride), -(-w // stride)
    return Layer(name, oh * ow * cout * cin * k * k, trainable, grad_input), oh, ow


def _trunk(arch, h, w, trainable: bool, prefix: str) -> tuple:
    """The stem and four stages; returns (layers, taps [(channels, h, w)])."""
    out: List[Layer] = []
    basic = arch["block"] == "basic"
    exp = 1 if basic else 4
    widths = arch["widths"]
    layer, h, w = _conv(f"{prefix}stem", h, w, 3, widths[0], 7, 2, trainable, False)
    out.append(layer)
    taps = [(widths[0], h, w)]
    h, w = -(-h // 2), -(-w // 2)  # max pool 3x3/s2, padding 1
    cin = widths[0]
    for s, (n, width) in enumerate(zip(arch["stage_sizes"], widths)):
        for i in range(n):
            stride = 2 if i == 0 and s > 0 else 1
            cout = width * exp
            name = f"{prefix}stage{s + 1}.{i}"
            flows = trainable  # a frozen trunk takes no gradient anywhere
            if i == 0 and (stride != 1 or cin != cout):
                ds, _, _ = _conv(name + ".down", h, w, cin, cout, 1, stride, trainable, flows)
                out.append(ds)
            if basic:
                c1, oh, ow = _conv(name + ".conv1", h, w, cin, width, 3, stride, trainable, flows)
                c2, _, _ = _conv(name + ".conv2", oh, ow, width, width, 3, 1, trainable, flows)
                out += [c1, c2]
            else:
                c1, _, _ = _conv(name + ".conv1", h, w, cin, width, 1, 1, trainable, flows)
                c2, oh, ow = _conv(name + ".conv2", h, w, width, width, 3, stride, trainable, flows)
                c3, _, _ = _conv(name + ".conv3", oh, ow, width, cout, 1, 1, trainable, flows)
                out += [c1, c2, c3]
            h, w, cin = oh, ow, cout
        taps.append((cin, h, w))
    return out, taps


def layers(arch: dict) -> List[Layer]:
    """Every layer with multiply-adds of a configuration's architecture."""
    size = arch["image_size"]
    if arch["kind"] == "resnet_classifier":
        trunk, taps = _trunk(arch, size, size, True, "")
        return trunk + [Layer("fc", taps[-1][0] * arch["num_classes"], True, True)]
    if arch["kind"] == "resnet_unet":
        trunk, taps = _trunk(arch, size, size, not arch["encoder_frozen"], "encoder.")
        out = list(trunk)
        c, h, w = taps[-1]
        for i, (deep, skip_ch, feats) in enumerate(arch["decoder"]):
            name = f"decoder{5 - i}"
            first = i == 0 and arch["encoder_frozen"]  # its input is the frozen e5
            out.append(Layer(name + ".up", h * w * deep * deep * 4, True, not first))
            h, w = 2 * h, 2 * w
            c1, _, _ = _conv(name + ".conv1", h, w, deep + skip_ch, feats, 3, 1, True, True)
            c2, _, _ = _conv(name + ".conv2", h, w, feats, feats, 3, 1, True, True)
            out += [c1, c2]
            c = feats
        half = c // 2
        out.append(Layer("decoder1.up", h * w * c * half * 4, True, True))
        h, w = 2 * h, 2 * w
        conv, _, _ = _conv("decoder1.conv", h, w, half, half, 3, 1, True, True)
        out.append(conv)
        out.append(Layer("out", h * w * half * arch["num_classes"], True, True))
        return out
    raise ValueError(f"no FLOP count for architecture {arch['kind']!r}")


def forward_flops(arch: dict) -> int:
    """Flops of one image's forward."""
    return 2 * sum(l.macs for l in layers(arch))


def train_flops(arch: dict) -> int:
    """Flops of one image's training step: forward and backward."""
    return 2 * sum(l.macs * (1 + l.trainable + l.grad_input) for l in layers(arch))
