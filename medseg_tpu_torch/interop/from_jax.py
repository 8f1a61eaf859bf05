"""Carry weights across: JAX-package flax variables -> the port's state dicts.

The variables are the nested dicts that flax's `init`/checkpoints hold
(numpy arrays, or any array type numpy can read).  Layout changes:
- conv kernel HWIO -> OIHW;
- ConvTranspose kernel [kh,kw,Ci,Co] -> [Ci,Co,kh,kw] with both spatial
  axes flipped first: flax writes out[2i+dy, 2j+dx] = x[i,j] @ W[1-dy,1-dx]
  (tests/test_upt.py), torch uses W[dy,dx];
- Dense kernel [in, out] -> Linear weight [out, in];
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  (plus num_batches_tracked = 0).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_STAGES = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3)}


def _tensor(a, transpose=None) -> torch.Tensor:
    a = np.asarray(a)
    if transpose is not None:
        a = a.transpose(transpose)
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _conv(sd: Dict[str, torch.Tensor], name: str, p: Mapping):
    sd[f"{name}.weight"] = _tensor(p["kernel"], (3, 2, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _tensor(p["bias"])


def _conv_transpose(sd: Dict[str, torch.Tensor], name: str, p: Mapping):
    sd[f"{name}.weight"] = _tensor(np.asarray(p["kernel"])[::-1, ::-1], (2, 3, 0, 1))
    sd[f"{name}.bias"] = _tensor(p["bias"])


def _bn(sd: Dict[str, torch.Tensor], name: str, p: Mapping, s: Mapping):
    sd[f"{name}.weight"] = _tensor(p["scale"])
    sd[f"{name}.bias"] = _tensor(p["bias"])
    sd[f"{name}.running_mean"] = _tensor(s["mean"])
    sd[f"{name}.running_var"] = _tensor(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _resnet_trunk(sd: Dict[str, torch.Tensor], p: Mapping, s: Mapping, depth: int,
                  stem=("conv1", "bn1"), stage="layer{}", first_stage=1):
    """The encoder's convs and BatchNorms, under `stem` and the stage names
    stage.format(first_stage + k)."""
    convs = ("conv1", "conv2", "conv3") if depth >= 50 else ("conv1", "conv2")
    _conv(sd, stem[0], p["conv1"])
    _bn(sd, stem[1], p["bn1"], s["bn1"])
    for k, n_blocks in enumerate(_STAGES[depth]):
        for i in range(n_blocks):
            name = f"layer{k + 1}_{i}"
            prefix = f"{stage.format(first_stage + k)}.{i}"
            bp, bs = p[name], s[name]
            for conv in convs:
                bn = conv.replace("conv", "bn")
                _conv(sd, f"{prefix}.{conv}", bp[conv])
                _bn(sd, f"{prefix}.{bn}", bp[bn], bs[bn])
            if "down_conv" in bp:
                _conv(sd, f"{prefix}.downsample.0", bp["down_conv"])
                _bn(sd, f"{prefix}.downsample.1", bp["down_bn"], bs["down_bn"])


def resnet_classifier_state_dict(variables: Mapping, depth: int) -> Dict[str, torch.Tensor]:
    """flax ResNetClassifier variables -> state dict of models.resnet's
    ResNetClassifier (torchvision names, head at fc.1)."""
    sd: Dict[str, torch.Tensor] = {}
    _resnet_trunk(sd, variables["params"]["encoder"],
                  variables["batch_stats"]["encoder"], depth)
    head = variables["params"]["head"]["fc"]
    sd["fc.1.weight"] = _tensor(head["kernel"], (1, 0))
    sd["fc.1.bias"] = _tensor(head["bias"])
    return sd


def _double_conv(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping, s: Mapping):
    """flax DoubleConv (conv1/conv2, each a ConvBN) -> nn.blocks.DoubleConv's
    Sequential indices 0, 1 and 3, 4."""
    for conv, index in (("conv1", 0), ("conv2", 3)):
        _conv(sd, f"{prefix}.{index}", p[conv]["conv"])
        _bn(sd, f"{prefix}.{index + 1}", p[conv]["bn"], s[conv]["bn"])


def resnet_unet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ResNetUnet variables -> state dict of models.resnet_unet's
    ResNetUnet (the reference's ResnetUnet.py names)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _resnet_trunk(sd, p["encoder"], s["encoder"], 50,
                  stem=("encoder1.0", "encoder1.1"), stage="encoder{}", first_stage=2)
    for i in range(5, 1, -1):
        _conv_transpose(sd, f"decoder{i}.up_sample", p[f"decoder{i}"]["up"])
        _double_conv(sd, f"decoder{i}.basic_block", p[f"decoder{i}"]["block"],
                     s[f"decoder{i}"]["block"])
    _conv_transpose(sd, "decoder1.0", p["up1"])
    _conv(sd, "decoder1.1", p["conv1"])
    _bn(sd, "decoder1.2", p["bn1"], s["bn1"])
    _conv(sd, "out", p["out"])
    return sd
