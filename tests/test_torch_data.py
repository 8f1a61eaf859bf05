"""Data layer parity: the port's packed sets, synthetic data and BatchLoader
against the JAX package's on the same seeds (byte for byte)."""

import numpy as np
import pytest
import torch

from medseg_tpu.data import loader as jloader
from medseg_tpu.data import packed as jpacked
from medseg_tpu.data import synthetic as jsynth
from medseg_tpu_torch.data import loader as tloader
from medseg_tpu_torch.data import packed as tpacked
from medseg_tpu_torch.data import synthetic as tsynth

torch.set_num_threads(1)


def _seg_set(n=10, size=8, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, size, size, 3), np.uint8)
    masks = (rng.random((n, size, size)) > 0.5).astype(np.uint8) * 255
    return images, np.arange(n, dtype=np.int32), masks


def _batches_jax(ds, **kw):
    return [(np.asarray(x), np.asarray(y)) for x, y in jloader.BatchLoader(ds, **kw)]


def _batches_port(ds, **kw):
    return [(x.numpy(), y.numpy())
            for x, y in tloader.BatchLoader(ds, device="cpu", **kw)]


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("with_masks", [False, True])
@pytest.mark.parametrize("pad", [None, 4])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_loader_matches_jax(shuffle, drop_last, pad, with_masks):
    images, labels, masks = _seg_set()
    masks = masks if with_masks else None
    kw = dict(batch_size=4, shuffle=shuffle, seed=3, drop_last=drop_last,
              pad_to_multiple=pad)
    jds = jpacked.PackedDataset(images, labels, masks)
    tds = tpacked.PackedDataset(images, labels, masks)
    jl = jloader.BatchLoader(jds, **kw)
    tl = tloader.BatchLoader(tds, device="cpu", **kw)
    assert len(jl) == len(tl)
    assert jl.real_counts() == tl.real_counts()
    for _ in range(2):  # two epochs: the shuffle RNG advances the same way
        _assert_same_batches(
            [(np.asarray(x), np.asarray(y)) for x, y in jl],
            [(x.numpy(), y.numpy()) for x, y in tl])
    jfull, jtail = jl.epoch_index_batches()
    tfull, ttail = tl.epoch_index_batches()
    np.testing.assert_array_equal(jfull, tfull)
    assert (jtail is None) == (ttail is None)
    if jtail is not None:
        np.testing.assert_array_equal(jtail, ttail)


@pytest.mark.parametrize("pad", [None, 4])
@pytest.mark.parametrize("drop_last", [False, True])
def test_device_cache_serves_the_same_batches(drop_last, pad):
    """index_select from the cached arrays == slicing the host arrays."""
    images, labels, _ = _seg_set(n=11)
    ds = tpacked.PackedDataset(images, labels)
    kw = dict(batch_size=4, shuffle=True, seed=1, drop_last=drop_last,
              pad_to_multiple=pad)
    cached = _batches_port(ds, device_cache=True, **kw)
    _assert_same_batches(cached, _batches_port(ds, **kw))
    if pad is None:  # the JAX device cache does not pad (ROADMAP C)
        jds = jpacked.PackedDataset(images, labels)
        _assert_same_batches(cached, _batches_jax(jds, device_cache=True, **kw))


def test_device_cache_budget_turns_the_cache_off():
    images, labels, _ = _seg_set()
    ds = tpacked.PackedDataset(images, labels)
    assert tloader.BatchLoader(ds, 4, shuffle=False, device="cpu",
                               device_cache=True).device_cache
    assert not tloader.BatchLoader(ds, 4, shuffle=False, device="cpu",
                                   device_cache=True,
                                   device_cache_budget=16).device_cache


@pytest.mark.parametrize("n,size,classes,seed", [(16, 64, 3, 0), (5, 32, 2, 7),
                                                 (3, 16, 1, 11)])
def test_synthetic_cls_is_byte_identical(n, size, classes, seed):
    a = jsynth.synthetic_cls(n, size, classes, seed)
    b = tsynth.synthetic_cls(n, size, classes, seed)
    for x, y in ((a.images, b.images), (a.labels, b.labels)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert b.masks is None and len(b) == n and b.img_size == size


@pytest.mark.parametrize("mmap", [False, True])
@pytest.mark.parametrize("with_masks", [False, True])
def test_packed_round_trip(tmp_path, mmap, with_masks):
    images, labels, masks = _seg_set()
    masks = masks if with_masks else None
    tpacked.save_packed(tpacked.PackedDataset(images, labels, masks),
                        str(tmp_path), "train")
    ds = tpacked.load_packed(str(tmp_path), "train", mmap=mmap)
    np.testing.assert_array_equal(ds.images, images)
    np.testing.assert_array_equal(ds.labels, labels)
    assert (ds.masks is None) == (masks is None)
    if masks is not None:
        np.testing.assert_array_equal(ds.masks, masks)
    # the JAX package reads the port's files and the other way round
    jds = jpacked.load_packed(str(tmp_path), "train", mmap=mmap)
    np.testing.assert_array_equal(jds.images, images)
    jpacked.save_packed(jds, str(tmp_path / "j"), "val")
    np.testing.assert_array_equal(
        tpacked.load_packed(str(tmp_path / "j"), "val").images, images)
