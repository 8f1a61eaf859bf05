"""Reference constants and the configs the port needs.

A copy of the corresponding parts of medseg_tpu/core/config.py; the values
reproduce the reference's hardcoded ones (reference utils/trainer.py:28-49).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Sequence

CLASSES: tuple[str, str, str] = ("COVID", "Healthy", "Non-COVID")
NUM_CLASSES: int = len(CLASSES)
IMG_SIZE: int = 256
IMAGENET_MEAN: tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: tuple[float, float, float] = (0.229, 0.224, 0.225)

# CLIP preprocessing constants (openai/clip-vit-base-patch32 processor).
CLIP_IMG_SIZE: int = 224
CLIP_MEAN: tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD: tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)
# CLIPSeg (CIDAS/clipseg-rd64-refined) operates on a 352x352 grid.
CLIPSEG_IMG_SIZE: int = 352

# Default text prompts (reference models/classification_models/CLIP.py:10-14).
DEFAULT_TEXT_PROMPTS: tuple[str, str, str] = (
    "a chest x-ray image showing COVID-19 pneumonia with ground-glass opacities",
    "a healthy normal chest x-ray image with clear lung fields",
    "a chest x-ray image showing non-COVID pneumonia infiltrates",
)
# Default segmentation prompt (reference models/segmentation_models/CLIPSeg.py:10).
DEFAULT_SEG_TEXT_PROMPT: str = "lungs"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset locations and split parameters.

    Split determinism contract: seed 42, stratified 80/10/10
    (reference utils/split_dataset.py:142-149).
    """

    root: str = "dataset"
    splits_dir: str = "dataset/splits"
    classes: Sequence[str] = CLASSES
    img_size: int = IMG_SIZE
    train_ratio: float = 0.8
    val_ratio: float = 0.1
    test_ratio: float = 0.1
    seed: int = 42

    def split_csv(self, split: str) -> Path:
        return Path(self.splits_dir) / f"{split}.csv"


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training recipe; defaults are the reference's hardcoded values.

    Two-stage classification recipe (reference utils/helpers.py:258-311):
    stage 1 = 5 epochs head-only at lr 1e-4 (cosine), stage 2 = remaining
    epochs full-network at `lr` with ReduceLROnPlateau(max, 0.1, patience 3).
    Segmentation: all-unfrozen AdamW at `lr` with cosine annealing.
    """

    epochs: int = 20
    lr: float = 1e-6
    weight_decay: float = 5e-4
    stage1_epochs: int = 5
    stage1_lr: float = 1e-4
    label_smoothing: float = 0.1
    grad_clip_norm: float = 1.0
    plateau_factor: float = 0.1
    plateau_patience: int = 3
    early_stop_patience: int = 10
    cls_batch_size: int = 16
    seg_batch_size: int = 8
    val_fraction: float = 0.2  # 80/20 random_split of train CSV (trainer.py:128-130)
    dropout: float = 0.5
    save_root: str = "weights"
    compute_dtype: str = "bfloat16"

    @property
    def cls_save_dir(self) -> Path:
        return Path(self.save_root) / "classification_models"

    @property
    def seg_save_dir(self) -> Path:
        return Path(self.save_root) / "segmentation_models"


@dataclasses.dataclass(frozen=True)
class CLIPFinetuneConfig:
    """CLIP vision-tower finetune recipe (reference utils/clip_finetuner.py:31-39)."""

    batch_size: int = 32
    epochs: int = 20
    lr: float = 5e-6
    weight_decay: float = 5e-4
    grad_clip_norm: float = 1.0
    early_stop_patience: int = 10
    save_root: str = "weights"


@dataclasses.dataclass(frozen=True)
class CLIPSegFinetuneConfig:
    """CLIPSeg decoder-only finetune recipe (reference utils/clip_seg_finetuner.py:25-32,121-135)."""

    batch_size: int = 8
    epochs: int = 20
    lr: float = 1e-5
    weight_decay: float = 0.01
    bce_weight: float = 0.5
    dice_weight: float = 0.5
    early_stop_patience: int = 10
    save_root: str = "weights"
