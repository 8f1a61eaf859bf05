"""Joining a data-parallel job: one process per card, from MEDSEG_* variables.

Counterpart of medseg_tpu/parallel/dist.py:51-99.  Every process runs the
same program and calls `initialize_from_env()` once, before anything
touches the card; it then joins a `torch.distributed` process group, and
`global_data_parallel_mesh()` is the group of every process.  Each process
loads and feeds only its own rows of a global batch.

Environment contract (nothing fires without it):

    MEDSEG_COORDINATOR   = host:port of process 0 (tcp://host:port), or a
                           torch init URL such as file:///path/to/store
    MEDSEG_NUM_PROCESSES = the world size
    MEDSEG_PROCESS_ID    = this process's rank

Process i drives cuda:{i % torch.cuda.device_count()} (core/device.py), so
several GPUs of one host take one process each.  The backend is NCCL for a
card and gloo for the CPU.  `MEDSEG_COORDINATOR=auto`, the JAX package's
TPU-pod autodetection, has no CUDA counterpart and raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from medseg_tpu_torch.core.device import DeviceLike, rank_device
from medseg_tpu_torch.parallel.sharding import DataParallelGroup, data_parallel_mesh

TIMEOUT = datetime.timedelta(minutes=10)


def initialize_from_env(env: Mapping[str, str] = os.environ,
                        backend: Optional[str] = None,
                        device: DeviceLike = None) -> bool:
    """Join the process group the MEDSEG_* variables describe; a no-op
    without them.  Returns True when this process is (now) in a group.
    Idempotent.

    device: this rank's device (default: its card, or the CPU when there is
    none); it decides the backend unless `backend` is given (gloo runs on
    the card too)."""
    coord = env.get("MEDSEG_COORDINATOR")
    if not coord:
        return False
    if dist.is_initialized():
        return True
    if coord == "auto":
        raise ValueError(
            "MEDSEG_COORDINATOR=auto (TPU-pod autodetection) has no CUDA "
            "counterpart: set MEDSEG_COORDINATOR=host:port, "
            "MEDSEG_NUM_PROCESSES and MEDSEG_PROCESS_ID explicitly")
    world, rank = int(env["MEDSEG_NUM_PROCESSES"]), int(env["MEDSEG_PROCESS_ID"])
    if device is not None:
        dev = torch.device(device)
    else:
        dev = rank_device(env) if torch.cuda.is_available() else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # before the first NCCL call
    init_method = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world, rank=rank,
                            timeout=TIMEOUT)
    return True


def global_data_parallel_mesh(device: DeviceLike = None) -> DataParallelGroup:
    """The group over every process: data_parallel_mesh(), named so call
    sites read as multi-process."""
    return data_parallel_mesh(device)


def shard_process_local(local_batch, group: DataParallelGroup) -> torch.Tensor:
    """This process's rows of the global batch, which it loaded itself, on
    its device.  Every rank must pass the same number of rows (the global
    batch is num_processes * rows); checked with one all-reduce, whose
    result every rank reads alike, so all of them raise together."""
    if isinstance(local_batch, np.ndarray):
        local_batch = torch.from_numpy(np.ascontiguousarray(local_batch))
    rows = local_batch.to(group.device)
    if group.joined:
        n = float(rows.shape[0])
        sums = group.all_reduce_(torch.tensor([n, n * n], dtype=torch.float64,
                                              device=group.device))
        total, squares = sums.tolist()
        if squares * group.size != total * total:
            raise ValueError(f"ranks passed different row counts (rank {group.rank}: "
                             f"{int(n)}, {int(total)} in all over {group.size})")
    return rows
