"""Stratified split generation reproducing the reference's determinism contract.

Counterpart of medseg_tpu/data/splits.py.  Contract (reference
utils/split_dataset.py:39-99,142-149): collect image ids per class
directory, then two chained `sklearn.model_selection.train_test_split(...,
stratify=labels, random_state=42)` calls, first carving out 20% (val+test),
then halving it.  The same ids must land in the same splits, or the
reference's `results/*.csv` replay compares different test images.

The port has no sklearn, so `stratified_split` repeats its arithmetic and
its draws in numpy, index for index (scikit-learn 1.x):
- sizes as `_validate_shuffle_split` computes them: n_test =
  ceil(test_size * n), n_train = n - n_test;
- then `StratifiedShuffleSplit._iter_indices`: classes by np.unique, each
  class's rows by a stable argsort, the per-class train and test counts by
  `_approximate_mode` (sklearn/utils/extmath.py, ties broken by
  rng.choice(..., replace=False)), one rng.permutation per class, and a
  final permutation of train and of test;
- every draw from one legacy np.random.RandomState(seed), in that order.
The CSVs are written with the standard library's `csv`, byte for byte what
pandas' `to_csv(index=False)` writes: header `id,class`, `\\n` line ends,
minimal quoting.
"""

from __future__ import annotations

import csv
import math
import os
from pathlib import Path
from typing import Sequence

import numpy as np

from medseg_tpu_torch.core.config import CLASSES, DataConfig


def collect_image_ids(data_root: str, classes: Sequence[str] = CLASSES):
    """(ids, labels) from dataset/<class>/images/*.png (split_dataset.py:19-36)."""
    ids, labels = [], []
    for cls in classes:
        img_dir = Path(data_root) / cls / "images"
        if not img_dir.is_dir():
            print(f"Warning: Image directory not found: {img_dir}")
            continue
        for f in sorted(img_dir.glob("*.png")):
            ids.append(f.stem)
            labels.append(cls)
    return np.asarray(ids), np.asarray(labels)


def _shuffle_split_sizes(n: int, test_size: float):
    """(n_train, n_test) of sklearn's _validate_shuffle_split for a float
    test_size and no train_size, with its errors."""
    if test_size <= 0 or test_size >= 1:
        raise ValueError(
            "test_size={0} should be either positive and smaller"
            " than the number of samples {1} or a float in the "
            "(0, 1) range".format(test_size, n))
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(
            "With n_samples={}, test_size={} and train_size={}, the "
            "resulting train set will be empty. Adjust any of the "
            "aforementioned parameters.".format(n, test_size, None))
    return n_train, n_test


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn.utils.extmath._approximate_mode: per-class counts summing to
    n_draws, the floors of the proportional shares topped up by largest
    remainder, ties broken by rng."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_train_test(labels, test_size: float, seed: int):
    """(train indices, test indices) of sklearn's
    train_test_split(..., test_size=test_size, stratify=labels,
    random_state=seed), with its ValueErrors."""
    labels = np.asarray(labels)
    n_train, n_test = _shuffle_split_sizes(len(labels), test_size)
    classes, y_indices, class_counts = np.unique(labels, return_inverse=True,
                                                 return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated classes in y have only 1"
            " member, which is too few. The minimum"
            " number of groups for any class cannot"
            " be less than 2. Classes with too few"
            " members are: %s" % (classes[class_counts < 2].tolist()))
    if n_train < n_classes:
        raise ValueError(
            "The train_size = %d should be greater or "
            "equal to the number of classes = %d" % (n_train, n_classes))
    if n_test < n_classes:
        raise ValueError(
            "The test_size = %d should be greater or "
            "equal to the number of classes = %d" % (n_test, n_classes))
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def stratified_split(ids, labels, train_ratio=0.8, val_ratio=0.1,
                     test_ratio=0.1, seed=42):
    """Two chained stratified splits, sklearn semantics, seed 42."""
    assert abs(train_ratio + val_ratio + test_ratio - 1.0) < 1e-6
    ids, labels = np.asarray(ids), np.asarray(labels)
    temp_ratio = val_ratio + test_ratio
    train, temp = stratified_train_test(labels, temp_ratio, seed)
    temp_ids, temp_y = ids[temp], labels[temp]
    val_size = val_ratio / temp_ratio
    val, test = stratified_train_test(temp_y, 1 - val_size, seed)
    return ((ids[train], labels[train]), (temp_ids[val], temp_y[val]),
            (temp_ids[test], temp_y[test]))


def write_split_csvs(splits, out_dir: str):
    """id,class CSVs named train/val/test.csv (split_dataset.py:102-130)."""
    os.makedirs(out_dir, exist_ok=True)
    for name, (ids, labels) in zip(("train", "val", "test"), splits):
        with open(Path(out_dir) / f"{name}.csv", "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(["id", "class"])
            writer.writerows(zip(ids.tolist(), labels.tolist()))


def print_split_summary(splits, classes: Sequence[str] = CLASSES):
    """Per-split sizes and class distribution (split_dataset.py:81-97)."""
    total = sum(len(ids) for ids, _ in splits)
    print("\nSplit summary:")
    for name, (ids, labels) in zip(("Train", "Validation", "Test"), splits):
        print(f"{name}: {len(ids)} images ({len(ids) / total * 100:.1f}%)")
    print("\nClass distribution:")
    for name, (ids, labels) in zip(("Train", "Validation", "Test"), splits):
        print(f"\n{name}:")
        for cls in classes:
            count = int(np.sum(labels == cls))
            pct = count / len(labels) * 100 if len(labels) else 0
            print(f"  {cls}: {count} ({pct:.1f}%)")


def generate_splits(cfg: DataConfig = DataConfig()):
    ids, labels = collect_image_ids(cfg.root, cfg.classes)
    if len(ids) == 0:
        raise ValueError("No images found in the dataset!")
    print(f"Total images found: {len(ids)}")
    splits = stratified_split(ids, labels, cfg.train_ratio, cfg.val_ratio,
                              cfg.test_ratio, cfg.seed)
    print_split_summary(splits, cfg.classes)
    write_split_csvs(splits, cfg.splits_dir)
    return splits
