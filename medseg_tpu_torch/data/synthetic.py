"""Synthetic datasets for tests and the chip smoke run (no disk or network).

Drawn with numpy from `seed` exactly as medseg_tpu/data/synthetic.py draws
them, so both packages see byte-identical arrays.
"""

from __future__ import annotations

import numpy as np

from medseg_tpu_torch.data.packed import PackedDataset


def synthetic_cls(n: int = 16, img_size: int = 64, num_classes: int = 3,
                  seed: int = 0) -> PackedDataset:
    """Class-separable blobs: mean intensity encodes the label."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    base = (labels * (200 // max(1, num_classes - 1)) + 20)[:, None, None, None]
    noise = rng.integers(0, 40, size=(n, img_size, img_size, 3))
    images = np.clip(base + noise, 0, 255).astype(np.uint8)
    return PackedDataset(images, labels)
