"""Split-CSV manifests: which files belong to which split.

Counterpart of medseg_tpu/data/manifest.py (the reference Dataset
constructors' CSV protocol, utils/dataset.py:24-98): rows are (id, class);
classification keeps samples whose image exists; segmentation keeps pairs
where BOTH image and mask exist.  The CSV is read with the standard
library's `csv`, so every id stays the string in the file.  pandas, which
the JAX package reads with, would turn a numeric-looking id into a number
("007" into 7, and so into "7.png"); the Kaggle dataset's ids carry their
class as a prefix ("COVID-1"), so the string is what both packages mean.
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import List, Optional

from medseg_tpu_torch.core.config import DataConfig


@dataclasses.dataclass
class Sample:
    image_path: Path
    label: int
    mask_path: Optional[Path] = None


def load_manifest(cfg: DataConfig, split: str, require_mask: bool = False) -> List[Sample]:
    csv_path = cfg.split_csv(split)
    if not csv_path.exists():
        raise FileNotFoundError(f"Split file not found: {csv_path}")
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    root = Path(cfg.root)
    classes = list(cfg.classes)
    samples: List[Sample] = []
    for row in rows:
        cls = row["class"]
        img = root / cls / "images" / f"{row['id']}.png"
        mask = root / cls / "masks" / f"{row['id']}.png"
        if not img.exists():
            continue
        if require_mask and not mask.exists():
            continue
        samples.append(Sample(img, classes.index(cls), mask if mask.exists() else None))
    return samples
