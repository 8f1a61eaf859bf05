"""Batch iteration over packed datasets, yielding uint8 tensors on a device.

Sample order comes from `np.random.default_rng(seed)` exactly as in
medseg_tpu/data/loader.py, so both packages visit the same batches; indices
are sorted within each batch.  With `device_cache=True` the packed arrays
are copied to the device once and batches are served by `index_select`,
which takes the per-step host-to-device copy off the critical path.

With a data-parallel `group` (medseg_tpu/data/loader.py's `sharding`),
every rank draws the same global order, forms the same global batch
(padded to `pad_to_multiple`) and yields only its own rows,
`[rank*b, (rank+1)*b)`, on its device; `real_counts()` gives each rank's
real rows and `global_real_counts()` the global batch's.  Unlike the JAX
loader, which drops its device cache under a mesh, each rank may keep the
packed arrays on its own card.
"""

from __future__ import annotations

import copy
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.data.packed import PackedDataset
from medseg_tpu_torch.parallel.sharding import batch_sharding, require_divisible_batch


class BatchLoader:
    def __init__(self, ds: PackedDataset, batch_size: int, *, shuffle: bool,
                 seed: int = 0, drop_last: bool = False,
                 pad_to_multiple: Optional[int] = None,
                 indices: Optional[np.ndarray] = None,
                 device_cache: bool = False,
                 device_cache_budget: int = 8 << 30,
                 device: DeviceLike = None, group=None):
        """pad_to_multiple: pad ragged batches up to a multiple of this by
        repeating the final sample; consumers trim per-sample outputs back
        with `real_counts()`.  Padding applies with and without the device
        cache.

        device_cache: keep the packed uint8 arrays on `device` (ignored when
        they exceed `device_cache_budget` bytes).

        group: a parallel.DataParallelGroup whose rank's rows to yield (may
        be set after construction, as train_model does on a copy)."""
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_to_multiple = pad_to_multiple
        self.indices = np.arange(len(ds)) if indices is None else np.asarray(indices)
        self.device = resolve_device(device)
        self.group = group
        self._rng = np.random.default_rng(seed)
        self._dev = None
        nbytes = ds.images.nbytes + (ds.masks.nbytes if ds.masks is not None
                                     else ds.labels.nbytes)
        self.device_cache = device_cache and nbytes <= device_cache_budget

    def _target(self) -> np.ndarray:
        return self.ds.masks if self.ds.masks is not None else self.ds.labels

    def _cached(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._dev is None:
            self._dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (self.ds.images, self._target()))
        return self._dev

    def __len__(self):
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def num_samples(self):
        return len(self.indices)

    def _stop(self, n: int) -> int:
        """Index past the last yielded sample: the one place the drop_last
        boundary rule lives (shared by __iter__ and real_counts)."""
        bs = self.batch_size
        return (n // bs) * bs if self.drop_last else n

    def global_real_counts(self):
        """Per-batch real sample counts of the global batch, ignoring
        pad_to_multiple padding."""
        n, bs = self.num_samples, self.batch_size
        return [min(bs, n - s) for s in range(0, self._stop(n), bs)]

    def real_counts(self):
        """Per-batch real sample counts of this rank's rows (the global
        counts without a group): pad rows sit at the global batch's end."""
        counts = self.global_real_counts()
        if self.group is None:
            return counts
        out = []
        for n in counts:
            rows = n + ((-n) % self.pad_to_multiple if self.pad_to_multiple else 0)
            b = rows // self.group.size
            out.append(min(b, max(0, n - self.group.rank * b)))
        return out

    def epoch_index_batches(self):
        """One epoch's batch indices for the scan-epoch driver
        (train/steps.scan_epoch_driver): ([n_full, b] int64 rows of the full
        batches; the ragged tail's rows or None), the batches one __iter__
        pass gathers, from the same shuffle draw: under a group this rank's
        rows of each global batch; without one the JAX loader's indices
        (medseg_tpu/data/loader.py:106-124), whose tail pad_to_multiple
        does not pad."""
        batches = list(self._batch_indices(pad=self.group is not None))
        n_full = self._stop(self.num_samples) // self.batch_size
        width = self.batch_size // (self.group.size if self.group is not None else 1)
        full = np.stack(batches[:n_full]) if n_full else np.zeros((0, width))
        return full.astype(np.int64), (batches[n_full] if len(batches) > n_full else None)

    def _batch_indices(self, pad: bool = True) -> Iterator[np.ndarray]:
        """One epoch's batch indices, each batch sorted; pad: pad a ragged
        batch to pad_to_multiple (if set)."""
        order = self.indices.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for start in range(0, self._stop(len(order)), bs):
            idx = np.sort(order[start:start + bs])  # sorted reads are faster on memmaps
            if pad and self.pad_to_multiple:
                n_pad = (-len(idx)) % self.pad_to_multiple
                if n_pad:
                    idx = np.concatenate([idx, np.repeat(idx[-1:], n_pad)])
            if self.group is not None:
                idx = idx[batch_sharding(self.group, len(idx))]
            yield idx

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        if self.device_cache:
            images_d, target_d = self._cached()
            for idx in self._batch_indices():
                idx_d = torch.from_numpy(idx).to(self.device)
                yield (torch.index_select(images_d, 0, idx_d),
                       torch.index_select(target_d, 0, idx_d))
            return
        target = self._target()
        for idx in self._batch_indices():
            yield tuple(
                torch.from_numpy(np.ascontiguousarray(a[idx])).to(self.device)
                for a in (self.ds.images, target))


def mesh_loaders(mesh, train: BatchLoader, val: BatchLoader) -> Tuple[BatchLoader, BatchLoader]:
    """Shallow copies of a train and a validation loader that yield the
    rank's rows over `mesh` (medseg_tpu/train/trainer.py:164-184): train
    batches drop their ragged tails, validation pads them to the group's
    size (the consumer masks the pad rows out), so every sample is scored
    once as without a mesh.  The caller's loaders come back untouched."""
    require_divisible_batch(mesh, train, val)
    train, val = copy.copy(train), copy.copy(val)
    train.group = val.group = mesh
    train.drop_last = True
    val.pad_to_multiple = mesh.size
    return train, val


def split_train_val(n: int, val_fraction: float, seed: int = 0):
    """The index split of the train manifest (medseg_tpu/data/loader.py:159;
    the reference's random_split, utils/trainer.py:128-133): the same
    permutation, so both packages train and validate on the same samples."""
    order = np.random.default_rng(seed).permutation(n)
    n_train = int((1.0 - val_fraction) * n)
    return order[:n_train], order[n_train:]
