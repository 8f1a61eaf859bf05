"""The port's data ingestion (ROADMAP A.15 part 1) against the JAX package:
manifests, the seed-42 stratified split (index for index sklearn's two
chained train_test_split calls), the split CSVs' bytes, packing on the cv2
route and on the native C++ route, the port's native loader against cv2,
and the CLI's `split` and `pack` against the JAX CLI's on the same PNG tree.
The port's CLI module imports, splits and packs with pandas and sklearn
blocked, and without initialising CUDA.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from sklearn.model_selection import train_test_split

import medseg_tpu.apps.cli as jcli
import medseg_tpu.data.manifest as jmanifest
import medseg_tpu.data.packed as jpacked
import medseg_tpu.data.splits as jsplits
import medseg_tpu.native.loader as jloader
from medseg_tpu.core.config import DataConfig as JDataConfig
from medseg_tpu_torch.apps import cli
from medseg_tpu_torch.core.config import CLASSES, DataConfig
from medseg_tpu_torch.data import manifest, packed, splits
from medseg_tpu_torch.native import loader

cv2 = pytest.importorskip("cv2")
ROOT = Path(__file__).resolve().parents[1]
# image sizes (H, W) cycled over each class's images: the Kaggle set's 299,
# a landscape and a portrait non-square one, and a small square one
SIZES = ((299, 299), (128, 200), (200, 128), (64, 64))


def write_tree(root: Path, per_class: int = 10, unmasked: int = 2, seed: int = 0):
    """dataset/<class>/{images,masks}/<class>-<i>.png; the last `unmasked`
    images of each class have no mask."""
    rng = np.random.default_rng(seed)
    for cls in CLASSES:
        (root / cls / "images").mkdir(parents=True)
        (root / cls / "masks").mkdir(parents=True)
        for i in range(per_class):
            h, w = SIZES[i % len(SIZES)]
            cv2.imwrite(str(root / cls / "images" / f"{cls}-{i}.png"),
                        rng.integers(0, 256, (h, w, 3), np.uint8))
            if i < per_class - unmasked:
                mask = (rng.random((h, w)) > 0.5).astype(np.uint8) * 255
                cv2.imwrite(str(root / cls / "masks" / f"{cls}-{i}.png"), mask)
    return root


def configs(root: Path):
    kw = dict(root=str(root), splits_dir=str(root / "splits"))
    return DataConfig(**kw), JDataConfig(**kw)


@pytest.fixture
def tree(tmp_path):
    return write_tree(tmp_path / "dataset")


# -- manifest ---------------------------------------------------------------

@pytest.mark.parametrize("require_mask", [False, True])
def test_load_manifest_matches_jax(tree, require_mask):
    """Rows whose image is missing are skipped; with require_mask, rows
    whose mask is missing too; mask_path is None where no mask exists."""
    cfg, jcfg = configs(tree)
    (tree / "splits").mkdir()
    rows = ["id,class", "COVID-0,COVID", "Healthy-9,Healthy", "Non-COVID-3,Non-COVID",
            "COVID-42,COVID", "Healthy-8,Healthy", "Non-COVID-1,Non-COVID"]
    (tree / "splits" / "val.csv").write_text("\n".join(rows) + "\n")
    ours = manifest.load_manifest(cfg, "val", require_mask=require_mask)
    want = jmanifest.load_manifest(jcfg, "val", require_mask=require_mask)
    assert [dataclasses.astuple(s) for s in ours] == [dataclasses.astuple(s) for s in want]
    assert len(ours) == (3 if require_mask else 5)
    assert (ours[1].mask_path is None) == (not require_mask)
    with pytest.raises(FileNotFoundError, match="Split file not found"):
        manifest.load_manifest(cfg, "test")


# -- the stratified split -----------------------------------------------------

def _sklearn_chain(ids, labels):
    tr, tmp, tr_y, tmp_y = train_test_split(ids, labels, test_size=0.2, stratify=labels,
                                            random_state=42)
    va, te, va_y, te_y = train_test_split(tmp, tmp_y, test_size=0.5, stratify=tmp_y,
                                          random_state=42)
    return (tr, tr_y), (va, va_y), (te, te_y)


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("counts", [
    (100, 100, 100), (20, 7, 3), (21, 13, 8), (11, 13, 17), (50, 51),
    (3000, 2000, 1500), (1, 10, 10), (2, 2, 2), (4, 4), (5, 5, 5, 5, 7)],
    ids=lambda c: "-".join(map(str, c)))
def test_stratified_split_matches_sklearn_and_jax(counts):
    """Index for index the JAX package's split (sklearn's chained calls),
    or the same ValueError: a class with one member, too few test rows
    for the classes."""
    names = ("COVID", "Healthy", "Non-COVID", "Other", "Rare")
    ids = np.array([f"{c}-{i}" for c, n in zip(names, counts) for i in range(n)])
    labels = np.array([c for c, n in zip(names, counts) for _ in range(n)])
    ours = _outcome(splits.stratified_split, ids, labels)
    for want in (_outcome(_sklearn_chain, ids, labels),
                 _outcome(jsplits.stratified_split, ids, labels)):
        if isinstance(want, str):
            assert ours == want
            continue
        assert not isinstance(ours, str), ours
        for (a_ids, a_y), (b_ids, b_y) in zip(ours, want):
            np.testing.assert_array_equal(a_ids, b_ids)
            np.testing.assert_array_equal(a_y, b_y)
    if counts == (100, 100, 100):
        assert [len(s[0]) for s in ours] == [240, 30, 30]
        for _, y in ours:
            assert len(set(np.unique(y, return_counts=True)[1])) == 1


def test_split_sizes_match_sklearn_errors():
    """The empty-train check of sklearn's _validate_shuffle_split."""
    labels = np.array(["a"])
    with pytest.raises(ValueError) as ours:
        splits.stratified_train_test(labels, 0.5, 42)
    with pytest.raises(ValueError) as want:
        train_test_split(np.arange(1), test_size=0.5, stratify=labels, random_state=42)
    assert str(ours.value) == str(want.value)
    assert "the resulting train set will be empty" in str(ours.value)


def test_write_split_csvs_bytes_equal_jax(tmp_path):
    """Header id,class, '\\n' line ends, minimal quoting: pandas' bytes."""
    ids = np.array(["COVID-1", "a,b", 'q"x', "Healthy-20", "plain"])
    labels = np.array(["COVID", "COVID", "Healthy", "Healthy", "Non-COVID"])
    parts = ((ids[:3], labels[:3]), (ids[3:4], labels[3:4]), (ids[:0], labels[:0]))
    splits.write_split_csvs(parts, str(tmp_path / "ours"))
    jsplits.write_split_csvs(parts, str(tmp_path / "jax"))
    for name in ("train", "val", "test"):
        a = (tmp_path / "ours" / f"{name}.csv").read_bytes()
        assert a == (tmp_path / "jax" / f"{name}.csv").read_bytes(), name
    assert (tmp_path / "ours" / "test.csv").read_bytes() == b"id,class\n"


def test_generate_splits_matches_jax(tree, tmp_path, capsys):
    cfg, _ = configs(tree)
    jcfg = JDataConfig(root=str(tree), splits_dir=str(tmp_path / "jax_splits"))
    ours = splits.generate_splits(cfg)
    out = capsys.readouterr().out
    want = jsplits.generate_splits(jcfg)
    assert out == capsys.readouterr().out
    for name in ("train", "val", "test"):
        assert (tree / "splits" / f"{name}.csv").read_bytes() == \
            (tmp_path / "jax_splits" / f"{name}.csv").read_bytes()
    for a, b in zip(ours, want):
        np.testing.assert_array_equal(a[0], b[0])


# -- packing -----------------------------------------------------------------

def _assert_packed_equal(a, b):
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.images.dtype == b.images.dtype and a.labels.dtype == b.labels.dtype
    assert (a.masks is None) == (b.masks is None)
    if a.masks is not None:
        np.testing.assert_array_equal(a.masks, b.masks)


@pytest.mark.parametrize("task", ["cls", "seg"])
def test_pack_split_cv2_route_bytes_equal_jax(tree, task):
    """cls letterboxes (299², 128x200, 200x128, 64x64 sources), seg
    resizes with nearest masks and keeps only rows with a mask."""
    cfg, jcfg = configs(tree)
    splits.generate_splits(cfg)
    for split in ("train", "test"):
        ours = packed.pack_split(cfg, split, task, img_size=64, use_native=False)
        want = jpacked.pack_split(jcfg, split, task, img_size=64, use_native=False)
        _assert_packed_equal(ours, want)
    assert ours.images.shape[1:] == (64, 64, 3)


@pytest.fixture
def native_pair(tmp_path, monkeypatch):
    """The port's loader (built into build/medseg_tpu_torch/) and the JAX
    package's, built into tmp_path so nothing is written into medseg_tpu/."""
    monkeypatch.setattr(jloader, "_LIB_PATH", tmp_path / "libmedseg_loader.so")
    monkeypatch.setattr(jloader, "_lib", None)
    if not loader.available() or not jloader.build(verbose=True):
        pytest.skip("native loader could not be built (no g++/libpng)")
    assert jloader.available()


@pytest.mark.parametrize("task", ["cls", "seg"])
def test_pack_split_native_route_bytes_equal_jax(tree, native_pair, task):
    cfg, jcfg = configs(tree)
    splits.generate_splits(cfg)
    ours = packed.pack_split(cfg, "train", task, img_size=64)
    want = jpacked.pack_split(jcfg, "train", task, img_size=64)
    _assert_packed_equal(ours, want)
    # ... and the native route is the one taken
    samples = manifest.load_manifest(cfg, "train", require_mask=task == "seg")
    _assert_packed_equal(ours, packed._pack_native(samples, task, 64, loader))


def test_native_library_is_named_by_its_source_and_flags():
    path = loader.library_path()
    assert path.parent == ROOT / "build" / "medseg_tpu_torch"
    assert path.name.startswith("libmedseg_loader-") and path.suffix == ".so"


@pytest.fixture
def built():
    if not loader.available():
        pytest.skip("native loader could not be built (no g++/libpng)")


@pytest.fixture
def png_files(tmp_path):
    rng = np.random.default_rng(0)
    paths, arrs = [], []
    for i, (h, w) in enumerate([(299, 299), (128, 200), (64, 64)]):
        arr = rng.integers(0, 256, (h, w, 3), np.uint8)
        p = tmp_path / f"img{i}.png"
        cv2.imwrite(str(p), arr[:, :, ::-1])  # cv2 writes BGR
        paths.append(str(p))
        arrs.append(arr)
    return paths, arrs


def test_native_rgb_bilinear_within_one_of_cv2(built, png_files):
    paths, arrs = png_files
    out = loader.decode_resize_batch(paths, 256, letterbox=False, gray=False)
    assert out.shape == (3, 256, 256, 3)
    for i, arr in enumerate(arrs):
        want = cv2.resize(arr.astype(np.float32), (256, 256),
                          interpolation=cv2.INTER_LINEAR)
        assert np.abs(out[i].astype(np.float32) - want).max() <= 1.01, i


def test_native_letterbox_pads_zero(built, png_files):
    paths, arrs = png_files
    out = loader.decode_resize_batch(paths, 256, letterbox=True, gray=False)
    h, w = arrs[1].shape[:2]
    nh = round(h * 256 / max(h, w))
    top = (256 - nh) // 2
    assert out[1][:top].max() == 0 and out[1][top + nh:].max() == 0
    assert out[1][top:top + nh].mean() > 10
    np.testing.assert_array_equal(out[0], loader.decode_resize_batch(
        paths[:1], 256, letterbox=False, gray=False)[0])  # square: a plain resize


def test_native_gray_nearest_masks(built, tmp_path):
    mask = (np.random.default_rng(1).random((299, 299)) > 0.5).astype(np.uint8) * 255
    p = tmp_path / "mask.png"
    cv2.imwrite(str(p), mask)
    out = loader.decode_resize_batch([str(p)], 256, letterbox=False, gray=True,
                                     nearest=True)
    assert out.shape == (1, 256, 256)
    want = cv2.resize(mask, (256, 256), interpolation=cv2.INTER_NEAREST)
    assert (out[0] != want).mean() < 0.01
    assert set(np.unique(out[0])).issubset({0, 255})


def test_native_missing_file_reports_its_index(built, png_files, tmp_path):
    paths, _ = png_files
    with pytest.raises(RuntimeError, match=r"native decode failed on 1: .*nope\.png"):
        loader.decode_resize_batch([paths[0], str(tmp_path / "nope.png")], 64,
                                   letterbox=False, gray=False, threads=1)


# -- the CLI ------------------------------------------------------------------

@pytest.mark.parametrize("route", ["cv2", "native"])
def test_cli_split_and_pack_equal_the_jax_clis(tmp_path, monkeypatch, capsys, route):
    """`split` then `pack` on two copies of one PNG tree: the port's CSVs,
    .npy files and printed lines are the JAX CLI's, byte for byte."""
    if route == "cv2":
        monkeypatch.setattr(loader, "available", lambda: False)
        monkeypatch.setattr(jloader, "available", lambda: False)
    else:
        monkeypatch.setattr(jloader, "_LIB_PATH", tmp_path / "libmedseg_loader.so")
        monkeypatch.setattr(jloader, "_lib", None)
        if not loader.available() or not jloader.build():
            pytest.skip("native loader could not be built (no g++/libpng)")
    monkeypatch.setenv("MEDSEG_JAX_CACHE", "0")
    ours_root = write_tree(tmp_path / "ours" / "dataset")
    jax_root = tmp_path / "jax" / "dataset"
    shutil.copytree(ours_root, jax_root)
    cli.main(["split", "--root", str(ours_root)])
    cli.main(["pack", "--root", str(ours_root), "--cache-dir", str(tmp_path / "ours_packed")])
    out = capsys.readouterr().out
    jcli.main(["split", "--root", str(jax_root)])
    jcli.main(["pack", "--root", str(jax_root), "--cache-dir", str(tmp_path / "jax_packed")])
    assert out.replace(str(ours_root), "ROOT") == \
        capsys.readouterr().out.replace(str(jax_root), "ROOT")
    assert "packed train/cls: 24 samples" in out and "packed test/cls: 3 samples" in out
    for name in ("train", "val", "test"):
        assert (ours_root / "splits" / f"{name}.csv").read_bytes() == \
            (jax_root / "splits" / f"{name}.csv").read_bytes()
    files = sorted(p.name for p in (tmp_path / "jax_packed").iterdir())
    assert sorted(p.name for p in (tmp_path / "ours_packed").iterdir()) == files
    assert len(files) == 15  # 6 caches: images + labels each, masks for seg
    for f in files:
        assert (tmp_path / "ours_packed" / f).read_bytes() == \
            (tmp_path / "jax_packed" / f).read_bytes(), f


def test_cli_splits_and_packs_without_pandas_sklearn_or_cuda(tmp_path):
    """In a fresh interpreter with pandas, sklearn and jax blocked, the CLI
    module imports and `split` + `pack` run to the end without initialising
    CUDA (the card's machine has neither pandas nor sklearn)."""
    write_tree(tmp_path / "dataset")
    code = textwrap.dedent("""
        import importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("pandas", "sklearn", "jax", "medseg_tpu"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import torch
        from medseg_tpu_torch.apps import cli
        cli.main(["split", "--root", "dataset"])
        cli.main(["pack", "--root", "dataset"])
        assert not torch.cuda.is_initialized()
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.endswith("ok\n") and "packed test/cls: 3 samples" in out.stdout
    assert (tmp_path / "dataset" / "packed" / "train_seg_masks.npy").exists()
