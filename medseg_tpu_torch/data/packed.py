"""Packed uint8 dataset cache: images [N,H,W,3] u8, masks [N,H,W] u8,
labels [N] i32, one flat .npy file each.

The same files medseg_tpu/data/packed.py writes; decoding and packing stay
host-side in the JAX package (`medseg pack`), so only the container and its
save/load are here.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np


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
