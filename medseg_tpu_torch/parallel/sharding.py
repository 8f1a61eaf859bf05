"""Data parallelism over a group of processes, one device each.

Counterpart of medseg_tpu/parallel/sharding.py.  Where the JAX package
shards one global array over a 1-D `Mesh(('data',))` from one program,
the port runs one process per card in a `torch.distributed` process group:
every process holds the whole model, forms the same global batch and
keeps its own rows, `[rank*b, (rank+1)*b)`.  A run over W ranks gives the
result of one process on the assembled global batch, up to the order of
float reductions:
- BatchNorm in training takes statistics over the global batch
  (nn/blocks.py::BatchNorm2d), as XLA's BN over a sharded batch does;
- batch-level sums of a loss or a metric (the dice's, the IoU's) reduce
  over the group through `all_reduce_sum`;
- the augmentation's and the dropout's draws are made for the global batch
  from the generator every rank shares, and each rank keeps its rows;
- train steps average the gradients over the group before the clip and
  AdamW (train/steps.py).

`DataParallelGroup` plays the role of the Mesh: its `size` is what
`require_divisible_batch` reads, as `mesh.size` in the JAX package.  The
modules learn of the group from a context, `data_parallel(group)`, which
the trainer, the finetuners and the harness enter around their loops;
`current_group()` reads it (None outside, the single-process code path).

Only three collectives are used: all_reduce, all_gather (the list form)
and broadcast, which gloo also offers for CUDA tensors.  Each call adds
one to `COLLECTIVE_COUNTS` (a world-1 group without a process group calls
none).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from medseg_tpu_torch.core.device import DeviceLike, resolve_device

COLLECTIVE_COUNTS = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


class DataParallelGroup:
    """The ranks that split a global batch: the process group (None for a
    world-1 group that joined none), this process's rank, the world size
    and this rank's device."""

    def __init__(self, process_group, rank: int, size: int, device: torch.device):
        if process_group is None and size != 1:
            raise ValueError("a group of more than one rank needs a process group")
        self.process_group = process_group
        self.rank = rank
        self.size = size
        self.device = torch.device(device)

    def __repr__(self):
        return (f"DataParallelGroup(rank={self.rank}, size={self.size}, "
                f"device={self.device}, joined={self.process_group is not None})")

    @property
    def joined(self) -> bool:
        return self.process_group is not None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks in place; returns it."""
        if self.joined:
            dist.all_reduce(t, group=self.process_group)
            COLLECTIVE_COUNTS["all_reduce"] += 1
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t` (all of one shape), in rank order."""
        if not self.joined:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.process_group)
        COLLECTIVE_COUNTS["all_gather"] += 1
        return out

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.joined:
            dist.broadcast(t, src, group=self.process_group)
            COLLECTIVE_COUNTS["broadcast"] += 1
        return t

    def barrier(self) -> None:
        """Every rank waits here for the others (one 1-element all-reduce)."""
        self.all_reduce_(torch.zeros(1, device=self.device))


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("medseg_data_parallel",
                                                         default=None)


@contextlib.contextmanager
def data_parallel(group: Optional[DataParallelGroup]) -> Iterator[None]:
    """Within the block, BatchNorm, dropout, the augmentation's draws, the
    batch-level loss sums and the train and eval steps work over `group`
    (None: one process, the plain code path)."""
    token = _CURRENT.set(group)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def current_group() -> Optional[DataParallelGroup]:
    return _CURRENT.get()


def data_parallel_mesh(device: DeviceLike = None) -> DataParallelGroup:
    """The group of every process that joined (parallel/dist.py), or a
    world-1 group of this process when none did.  device: this rank's
    (default: the rank's card, core/device.py)."""
    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return DataParallelGroup(dist.group.WORLD, dist.get_rank(),
                                 dist.get_world_size(), device)
    return DataParallelGroup(None, 0, 1, device)


def pad_to_multiple(batch: np.ndarray, multiple: int):
    """Pad the leading dim up to a multiple; returns (padded, real_count)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    pad_width = [(0, rem)] + [(0, 0)] * (batch.ndim - 1)
    return np.pad(batch, pad_width), n


def batch_sharding(group: DataParallelGroup, rows: int) -> slice:
    """This rank's rows of a global batch of `rows`: [rank*b, (rank+1)*b)."""
    if rows % group.size:
        raise ValueError(f"a batch of {rows} rows does not split across the "
                         f"{group.size}-rank data-parallel group")
    b = rows // group.size
    return slice(group.rank * b, (group.rank + 1) * b)


def shard_batch(batch, group: DataParallelGroup) -> torch.Tensor:
    """This rank's rows of a global batch (numpy or tensor) on its device."""
    rows = batch[batch_sharding(group, batch.shape[0])]
    if isinstance(rows, np.ndarray):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    return rows.to(group.device)


def replicated(tensors: Sequence[torch.Tensor], group: DataParallelGroup,
               src: int = 0) -> None:
    """Overwrite `tensors` in place with rank `src`'s values: one broadcast
    per dtype of one flattened copy."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        group.broadcast_(flat, src)
        for t, v in zip(ts, torch.split(flat, [t.numel() for t in ts])):
            t.detach().copy_(v.view_as(t))


@torch.no_grad()
def replicate_(module: torch.nn.Module, group: DataParallelGroup) -> torch.nn.Module:
    """Broadcast the module's parameters and buffers from rank 0: the
    counterpart of `device_put(state, replicated(mesh))`."""
    if group.joined:
        replicated(list(module.parameters()) + list(module.buffers()), group)
    return module


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of every rank's copy is summed too.
    Every rank computes the same global value, and the train step then
    averages the parameter gradients over W ranks, so the backward must
    sum (an identity backward would leave them W times too small)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: DataParallelGroup):
        ctx.group = group
        return group.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.group.all_reduce_(grad.clone()), None


def all_reduce_sum(x: torch.Tensor,
                   group: Optional[DataParallelGroup] = None) -> torch.Tensor:
    """`x` summed over `group` (default: current_group()), differentiable;
    `x` itself without a joined group."""
    group = group if group is not None else current_group()
    if group is None or not group.joined:
        return x
    return _AllReduceSum.apply(x, group)


def global_rows(rows: int) -> int:
    """The row count to draw for a local batch of `rows` under the current
    group: the global batch's."""
    group = current_group()
    return rows if group is None else rows * group.size


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a draw made for the global batch (global_rows)."""
    group = current_group()
    return t if group is None else t[batch_sharding(group, t.shape[0])]


def require_divisible_batch(mesh: DataParallelGroup, *loaders) -> None:
    """Fail fast when a loader's batch cannot split across the ranks."""
    for ld in loaders:
        if ld is None:
            continue
        if ld.batch_size % mesh.size != 0:
            rounded = -(-ld.batch_size // mesh.size) * mesh.size
            raise ValueError(
                f"batch_size={ld.batch_size} does not divide across the "
                f"{mesh.size}-device data-parallel mesh; use a multiple of "
                f"{mesh.size} (e.g. {rounded}).")
