"""Driver `dp_train_epochs`: `train_epochs` under data parallelism, one
process a card.

The parent spawns the cell's ranks the way `medseg train --data-parallel`
is launched on a host (MEDSEG_COORDINATOR on localhost at a port chosen
now, MEDSEG_NUM_PROCESSES, MEDSEG_PROCESS_ID; NCCL on the card, gloo on
the CPU) and touches no card itself.  Each rank joins the group
(parallel.initialize_from_env), builds the same training object on its
card and runs train_epochs' set-up, first steps and window inside
`parallel.data_parallel`: global-batch BatchNorm statistics, the global
batch's draws, and the gradient bucket's all-reduce inside the captured
graph.  The ranks stop together: after each epoch one all-reduce of each
rank's "time is up".  Rank 0 reads the per-layer metrics from its own
trace and runs the check (the reference follows the first steps of the
global batches on one card, so the cross-rank statistics and the gradient
all-reduce are compared); each rank writes its result to a file, and the
parent prints the result line.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile
import time
from pathlib import Path

import torch

JOIN_S = 330  # a rank that has not ended by then is stopped


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, cell, seed: int, seconds: float, trace_on: bool,
          t_start: float, work: str, cpu: bool) -> None:
    import torch.distributed as dist

    from benchmark.drivers import train_epochs
    from benchmark.harness import guard, runner
    from medseg_tpu_torch.parallel import data_parallel_mesh, initialize_from_env

    os.environ.update(MEDSEG_COORDINATOR=f"127.0.0.1:{port}", MEDSEG_NUM_PROCESSES=str(world),
                      MEDSEG_PROCESS_ID=str(rank))
    device = torch.device("cpu") if cpu else torch.device("cuda", rank)
    initialize_from_env(device=device)
    try:
        group = data_parallel_mesh(device)
        flag = torch.zeros(1, device=device)

        def stop_all(mine: bool) -> bool:
            flag.fill_(float(mine))
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            return bool(flag.item())

        out = train_epochs.measure(cell, seed, seconds, trace_on, device, group, stop_all,
                                   t_start)
        mine = {"peak": out.memory_peak_bytes, "forbidden": guard.forbidden(),
                "busy_s": out.session.busy_s if out.session else None}
        if rank == 0:
            result = runner.finish(cell, out, trace_on, device)
            mine["result"] = result
        Path(work, f"rank{rank}.json").write_text(json.dumps(mine))
    finally:
        dist.destroy_process_group()


def run(cell, seed: int, seconds: float, trace_on: bool, device, t_start: float):
    """Returns the finished result of rank 0 with the ranks' peak memory and
    busy seconds merged, or raises when a rank fails."""
    import torch.multiprocessing as mp

    world = cell.chips
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as work:
        port = _free_port()
        procs = [ctx.Process(target=_rank, args=(r, world, port, cell, seed, seconds, trace_on,
                                                 t_start, work, device.type == "cpu"))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.time() + JOIN_S
        try:
            for p in procs:
                p.join(max(1.0, deadline - time.time()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"rank exit codes {codes}")
        ranks = [json.loads(Path(work, f"rank{r}.json").read_text()) for r in range(world)]
    found = sorted({n for r in ranks for n in r["forbidden"]})
    if found:
        print(f"benchmark: forbidden modules loaded in a rank: {found}", file=sys.stderr)
        raise SystemExit(1)
    result = ranks[0]["result"]
    result["device"]["memory_peak_bytes"] = max(r["peak"] for r in ranks)
    if trace_on:
        result["device"]["busy_s"] = sum(r["busy_s"] for r in ranks) / world
    for key in ("readings", "checks"):  # last
        result[key] = result.pop(key)
    return result
