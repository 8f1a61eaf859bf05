"""Which parameters train: predicates over the port's parameter names.

Counterpart of medseg_tpu/train/freeze.py.  The reference freezes with
`param.requires_grad = False` (utils/helpers.py:263-276); the JAX package
masks the optimizer.  The port does what the reference does: a frozen
parameter gets requires_grad=False and stays out of the optimizer, so it
gets no update, no weight decay and no share of the global-norm clip.
Names are torchvision's (`fc.1.weight`, `layer1.0.conv1.weight`,
`classifier.0.weight`, ...), the reference ResNetUnet's
(`encoder1.0.weight`, `decoder5.up_sample.bias`, ...) and HF's for CLIP
and CLIPSeg (`vision_model.encoder.layers.0.mlp.fc1.weight`,
`decoder.film_mul.weight`, ...).
"""

from __future__ import annotations

from typing import Callable, List

from torch import nn

NamePredicate = Callable[[str], bool]


def all_trainable(name: str) -> bool:
    return True


def head_only(model_name: str) -> NamePredicate:
    """Stage-1 classification predicate: the attr the reference unfreezes
    (utils/helpers.py:270-276), the `fc` head for ResNets (the JAX
    package's `path[0] == "head"`) and the whole `classifier` stack for
    VGGs (its fc1, fc2 and head_fc)."""
    name = model_name.lower()
    if name.startswith("resnet"):
        return lambda n: n.startswith("fc.")
    if name.startswith("vgg"):
        return lambda n: n.startswith("classifier.")
    raise ValueError(f"no stage-1 head rule for {model_name}")


def set_trainable(model: nn.Module, pred: NamePredicate) -> List[nn.Parameter]:
    """requires_grad = pred(name) for every parameter; returns the
    trainable ones in the model's order."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(pred(name))
        if p.requires_grad:
            trainable.append(p)
    return trainable


_UNET_ENCODER = frozenset(f"encoder{i}" for i in range(1, 6))


def finetune_filter(model_name: str) -> NamePredicate:
    """Which parameters train in the model's single-stage recipe
    (medseg_tpu/train/freeze.py:56-68).  CLIP trains its vision tower only
    (clip_finetuner.py:91-99; the JAX package's path[0] == "vision"), so
    visual_projection and logit_scale stay; CLIPSeg its decoder only
    (clip_seg_finetuner.py:125-132).  ResNetUnet keeps its encoder frozen
    (reference ResnetUnet.py:30,45-46): the JAX package tests path[0] ==
    "encoder"; here the encoder is the top-level modules
    encoder1-encoder5.  Every other model (the AttentionUNet and R2 U-Nets
    among them) trains whole."""
    name = model_name.lower()
    if name == "clip":
        return lambda n: n.startswith("vision_model.")
    if name == "clipseg":
        return lambda n: n.startswith("decoder.")
    if name == "resnetunet":
        return lambda n: n.split(".", 1)[0] not in _UNET_ENCODER
    return all_trainable
