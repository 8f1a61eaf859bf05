"""Carry weights across: JAX-package flax variables -> the port's state dicts.

The variables are the nested dicts that flax's `init`/checkpoints hold
(numpy arrays, or any array type numpy can read).  Layout changes:
- conv kernel HWIO -> OIHW;
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


def _bn(sd: Dict[str, torch.Tensor], name: str, p: Mapping, s: Mapping):
    sd[f"{name}.weight"] = _tensor(p["scale"])
    sd[f"{name}.bias"] = _tensor(p["bias"])
    sd[f"{name}.running_mean"] = _tensor(s["mean"])
    sd[f"{name}.running_var"] = _tensor(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def resnet_classifier_state_dict(variables: Mapping, depth: int) -> Dict[str, torch.Tensor]:
    """flax ResNetClassifier variables -> state dict of models.resnet's
    ResNetClassifier (torchvision names, head at fc.1)."""
    p = variables["params"]["encoder"]
    s = variables["batch_stats"]["encoder"]
    convs = ("conv1", "conv2", "conv3") if depth >= 50 else ("conv1", "conv2")
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv1", p["conv1"])
    _bn(sd, "bn1", p["bn1"], s["bn1"])
    for stage, n_blocks in enumerate(_STAGES[depth]):
        for i in range(n_blocks):
            name = f"layer{stage + 1}_{i}"
            prefix = f"layer{stage + 1}.{i}"
            bp, bs = p[name], s[name]
            for conv in convs:
                bn = conv.replace("conv", "bn")
                _conv(sd, f"{prefix}.{conv}", bp[conv])
                _bn(sd, f"{prefix}.{bn}", bp[bn], bs[bn])
            if "down_conv" in bp:
                _conv(sd, f"{prefix}.downsample.0", bp["down_conv"])
                _bn(sd, f"{prefix}.downsample.1", bp["down_bn"], bs["down_bn"])
    head = variables["params"]["head"]["fc"]
    sd["fc.1.weight"] = _tensor(head["kernel"], (1, 0))
    sd["fc.1.bias"] = _tensor(head["bias"])
    return sd
