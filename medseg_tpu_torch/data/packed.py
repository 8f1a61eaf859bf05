"""Packed uint8 dataset cache: decode + resize once, then stay device-friendly.

Counterpart of medseg_tpu/data/packed.py, the same files: each split is
decoded, letterboxed/resized to the 256 grid once, and packed into flat .npy
arrays (images [N,256,256,3] u8, masks [N,256,256] u8, labels [N] i32).
Per-epoch randomness (shift-scale-rotate, flip, brightness) runs on the card
inside the train step (ops/augment.py), so steady-state training does no
host image processing.

Resize semantics per task (reference utils/trainer.py:52-115):
- classification: LongestMaxSize(256) + centered zero pad (letterbox)
- segmentation: plain Resize(256,256); masks nearest
Decoding prefers the native C++ loader (native/loader.py, built at first
use) and falls back to cv2/PIL when g++ or libpng is missing.  Packing is
host work: it never touches the card.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from medseg_tpu_torch.core.config import IMG_SIZE, DataConfig
from medseg_tpu_torch.data.manifest import Sample, load_manifest


def _decode_rgb(path: Path) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_COLOR)  # BGR
        if img is None:
            raise IOError(path)
        return img[:, :, ::-1]
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))


def _decode_gray(path: Path) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(path)
        return img
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"))


def _letterbox_u8(img: np.ndarray, size: int) -> np.ndarray:
    import cv2

    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    r = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    top = (size - nh) // 2
    left = (size - nw) // 2
    out = np.zeros((size, size) + img.shape[2:], dtype=img.dtype)
    out[top:top + nh, left:left + nw] = r
    return out


def _resize_u8(img: np.ndarray, size: int, nearest: bool = False) -> np.ndarray:
    import cv2

    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    return cv2.resize(img, (size, size), interpolation=interp)


class PackedDataset:
    """In-memory (or memmapped) uint8 arrays for one split."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 masks: Optional[np.ndarray] = None):
        self.images = images
        self.labels = labels
        self.masks = masks

    def __len__(self):
        return len(self.images)

    @property
    def img_size(self) -> int:
        return self.images.shape[1]


def pack_split(cfg: DataConfig, split: str, task: str,
               img_size: int = IMG_SIZE, use_native: bool = True) -> PackedDataset:
    """Decode + resize a split into packed arrays (task: 'cls' or 'seg')."""
    require_mask = task == "seg"
    samples = load_manifest(cfg, split, require_mask=require_mask)
    if use_native:
        try:
            from medseg_tpu_torch.native import loader as native_loader

            if native_loader.available():
                return _pack_native(samples, task, img_size, native_loader)
        except Exception:
            pass
    return _pack_python(samples, task, img_size)


def _pack_python(samples: List[Sample], task: str, img_size: int) -> PackedDataset:
    n = len(samples)
    images = np.zeros((n, img_size, img_size, 3), np.uint8)
    labels = np.zeros((n,), np.int32)
    masks = np.zeros((n, img_size, img_size), np.uint8) if task == "seg" else None
    for i, s in enumerate(samples):
        img = _decode_rgb(s.image_path)
        if task == "cls":
            images[i] = _letterbox_u8(img, img_size)
        else:
            images[i] = _resize_u8(img, img_size)
            masks[i] = _resize_u8(_decode_gray(s.mask_path), img_size, nearest=True)
        labels[i] = s.label
    return PackedDataset(images, labels, masks)


def _pack_native(samples: List[Sample], task: str, img_size: int,
                 native_loader) -> PackedDataset:
    """Multithreaded C++ decode+resize path."""
    img_paths = [str(s.image_path) for s in samples]
    letterbox = task == "cls"
    images = native_loader.decode_resize_batch(img_paths, img_size,
                                               letterbox=letterbox, gray=False)
    labels = np.asarray([s.label for s in samples], np.int32)
    masks = None
    if task == "seg":
        mask_paths = [str(s.mask_path) for s in samples]
        masks = native_loader.decode_resize_batch(mask_paths, img_size,
                                                  letterbox=False, gray=True,
                                                  nearest=True)
    return PackedDataset(images, labels, masks)


def save_packed(ds: PackedDataset, out_dir: str, name: str):
    os.makedirs(out_dir, exist_ok=True)
    np.save(Path(out_dir) / f"{name}_images.npy", ds.images)
    np.save(Path(out_dir) / f"{name}_labels.npy", ds.labels)
    if ds.masks is not None:
        np.save(Path(out_dir) / f"{name}_masks.npy", ds.masks)


def load_packed(out_dir: str, name: str, mmap: bool = True) -> PackedDataset:
    mode = "r" if mmap else None
    images = np.load(Path(out_dir) / f"{name}_images.npy", mmap_mode=mode)
    labels = np.load(Path(out_dir) / f"{name}_labels.npy")
    mask_file = Path(out_dir) / f"{name}_masks.npy"
    masks = np.load(mask_file, mmap_mode=mode) if mask_file.exists() else None
    return PackedDataset(images, labels, masks)
