"""Which parameters train: predicates over the port's parameter names.

Counterpart of medseg_tpu/train/freeze.py.  The reference freezes with
`param.requires_grad = False` (utils/helpers.py:263-276); the JAX package
masks the optimizer.  The port does what the reference does: a frozen
parameter gets requires_grad=False and stays out of the optimizer, so it
gets no update, no weight decay and no share of the global-norm clip.
Names are torchvision's (`fc.1.weight`, `layer1.0.conv1.weight`, ...).
`finetune_filter` comes with the segmentation slice and the finetuners
(ROADMAP A.8, A.13).
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
    package's `path[0] == "head"`).  VGG's classifier stack comes with the
    VGG port (ROADMAP A.10)."""
    if model_name.lower().startswith("resnet"):
        return lambda name: name.startswith("fc.")
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
