"""Exploratory data analysis of the dataset's PNG tree, on the host.

Counterpart of medseg_tpu/apps/eda.py (reference utils/helpers.py:25-118
and notebooks/EDA.ipynb): per-class image and mask counts, sample grids,
image / mask / overlay triptychs, and count bar and pie charts.  The
plotting functions return the matplotlib figure, drawn headless (Agg),
so they compose in notebooks or save to disk.  matplotlib is imported
inside them only, so the module imports where it is absent.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Sequence

import numpy as np

from medseg_tpu_torch.core.config import CLASSES


def get_dataset_stats(data_root: str = "dataset",
                      classes: Sequence[str] = CLASSES) -> Dict:
    """Per-class image/mask counts + sample paths (helpers.py:25-49)."""
    stats = {}
    for cls in classes:
        img_path = os.path.join(data_root, cls, "images")
        mask_path = os.path.join(data_root, cls, "masks")
        img_files = sorted(glob.glob(os.path.join(img_path, "*.png"))) \
            if os.path.exists(img_path) else []
        mask_files = sorted(glob.glob(os.path.join(mask_path, "*.png"))) \
            if os.path.exists(mask_path) else []
        if not img_files:
            print(f"Warning: Image directory not found: {img_path}")
        stats[cls] = {
            "images": len(img_files),
            "masks": len(mask_files),
            "image_paths": img_files[:10],
            "mask_paths": mask_files[:10],
        }
    return stats


def _imread_rgb(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _imread_gray(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


def visualize_samples(n_samples: int = 6, classes: Sequence[str] = CLASSES,
                      data_root: str = "dataset", save_path: Optional[str] = None):
    """Grid of sample images per class (helpers.py:52-69)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(classes), n_samples, figsize=(20, 10),
                             squeeze=False)
    for row, cls in enumerate(classes):
        files = sorted(glob.glob(os.path.join(data_root, cls, "images",
                                              "*.png")))[:n_samples]
        for col in range(n_samples):
            ax = axes[row][col]
            ax.axis("off")
            if col < len(files):
                ax.imshow(_imread_rgb(files[col]))
                ax.set_title(f"{cls}\n{os.path.basename(files[col])}",
                             fontsize=10)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    return fig


def visualize_image_mask_pairs(n_samples: int = 3,
                               classes: Sequence[str] = CLASSES,
                               data_root: str = "dataset",
                               save_path: Optional[str] = None):
    """Image / mask / red-overlay triptychs per class (helpers.py:72-118)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    fig, axes = plt.subplots(len(classes), n_samples * 3, figsize=(20, 10),
                             squeeze=False)
    for row, cls in enumerate(classes):
        files = sorted(glob.glob(os.path.join(data_root, cls, "images",
                                              "*.png")))[:n_samples]
        for col in range(n_samples * 3):
            axes[row][col].axis("off")
        for col, img_file in enumerate(files):
            img = _imread_rgb(img_file)
            mask_file = os.path.join(data_root, cls, "masks",
                                     os.path.basename(img_file))
            axes[row][col * 3].imshow(img)
            axes[row][col * 3].set_title(f"{cls} - Original", fontsize=10)
            if os.path.exists(mask_file):
                mask_img = Image.open(mask_file).convert("L")
                if mask_img.size != (img.shape[1], img.shape[0]):
                    mask_img = mask_img.resize((img.shape[1], img.shape[0]),
                                               Image.NEAREST)
                mask = np.asarray(mask_img)
                axes[row][col * 3 + 1].imshow(mask, cmap="gray")
                axes[row][col * 3 + 1].set_title("Mask", fontsize=10)
                overlay = img.copy()
                overlay[mask > 128] = (255, 0, 0)
                axes[row][col * 3 + 2].imshow(overlay)
                axes[row][col * 3 + 2].set_title("Overlay", fontsize=10)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    return fig


def plot_class_distribution(stats: Dict, save_path: Optional[str] = None):
    """Bar + pie chart of per-class counts (EDA.ipynb final cells)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(stats.keys())
    counts = [stats[c]["images"] for c in names]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    ax1.bar(names, counts)
    ax1.set_ylabel("images")
    ax1.set_title("Images per class")
    ax2.pie(counts, labels=names, autopct="%1.1f%%")
    ax2.set_title("Class distribution")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    return fig
