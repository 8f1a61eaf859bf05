"""Reference constants and the configs this slice needs.

A copy of the corresponding parts of medseg_tpu/core/config.py; the values
reproduce the reference's hardcoded ones (reference utils/trainer.py:28-49).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

CLASSES: tuple[str, str, str] = ("COVID", "Healthy", "Non-COVID")
NUM_CLASSES: int = len(CLASSES)
IMG_SIZE: int = 256
IMAGENET_MEAN: tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Training-time augmentation parameters.

    Mirrors the Albumentations chain at reference utils/trainer.py:52-115:
    ShiftScaleRotate(shift=0.05, scale=0.05, rotate=15deg, p=0.7),
    HorizontalFlip(p=0.5), RandomBrightnessContrast(0.1, 0.1, p=0.5),
    then ImageNet Normalize, with reflect-101 affine borders.
    """

    shift_limit: float = 0.05
    scale_limit: float = 0.05
    rotate_limit_deg: float = 15.0
    affine_p: float = 0.7
    hflip_p: float = 0.5
    brightness_limit: float = 0.1
    contrast_limit: float = 0.1
    brightness_contrast_p: float = 0.5
    mean: Sequence[float] = IMAGENET_MEAN
    std: Sequence[float] = IMAGENET_STD


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation harness settings (reference utils/tester.py:513-554)."""

    batch_size: int = 16
    threshold: float = 0.5
    results_dir: str = "results"
    weights_root: str = "weights"
