#!/usr/bin/env python3
"""Data parallelism of the port over the GPUs of one host, one process each.

    python3 dp_scaling.py [--ranks 4] [--steps 10] [--batch 16]

For a world of 1 and of RANKS processes (MEDSEG_* over NCCL, rank i on
cuda:i, spawned), each rank runs ResNet18's stage-2 train step in bf16 at
256px on its B rows of a global batch of B x world, augmented by one B1
launch, under `parallel.data_parallel`: its all-reduce launches a step
(against the design's: a training BatchNorm's forward one, its backward
one, one gradient bucket), STEPS steps by host clock, one profiler session
of 4 steps (the step's device time and NCCL's kernels in it), and one
float64 step on 2 rows a rank.  Then one process on cuda:0 runs that
float64 step on the assembled global batch: the ranks' loss and every
parameter and running statistic must lie within 1e-9 of it, and the ranks
must agree bit for bit.  It prints one line a world and a JSON line of the
readings, beside the card's name and power limit; it exits non-zero
without RANKS cards or on any failure.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
F64_ROWS = 2  # rows a rank in the float64 parity step


def _rank_main(rank: int, world: int, port: int, work: str, steps: int, batch: int) -> None:
    """One rank: the readings and the float64 step, saved to WORK."""
    import chip_smoke as cs
    from medseg_tpu_torch.data.synthetic import synthetic_cls
    from medseg_tpu_torch.models.resnet import init_weights, resnet18
    from medseg_tpu_torch.ops.augment import augment_batch
    from medseg_tpu_torch.parallel import data_parallel, data_parallel_mesh, initialize_from_env
    from medseg_tpu_torch.parallel.sharding import COLLECTIVE_COUNTS
    from medseg_tpu_torch.train import steps as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(MEDSEG_COORDINATOR=f"127.0.0.1:{port}", MEDSEG_NUM_PROCESSES=str(world),
                      MEDSEG_PROCESS_ID=str(rank))
    initialize_from_env()
    try:
        group = data_parallel_mesh()
        ds = synthetic_cls(n=batch * world, img_size=cs.SIZE, seed=cs.SEED + 40)
        images, labels = cs._dp_rows(ds.images, group), cs._dp_rows(ds.labels, group)
        model = resnet18(dtype=torch.bfloat16, device="cuda")  # float32 parameters
        init_weights(model, torch.Generator(device="cuda").manual_seed(cs.SEED))
        opt = S.build_optimizer(cs.DP_LR, 5e-4, 1.0, list(model.train().parameters()))
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

        def step():
            S.cls_train_step(model, opt, images, labels, gen, 0.1, prep=lambda g, x, y: (
                augment_batch(g, x, out_dtype=torch.bfloat16)[0], y))

        out = {"device": str(group.device)}
        with data_parallel(group):
            for _ in range(3):
                step()
            counts, handles = cs._dp_bn_counts(model)
            torch.cuda.synchronize()
            before = COLLECTIVE_COUNTS["all_reduce"]
            step()
            torch.cuda.synchronize()
            out["all_reduce"] = COLLECTIVE_COUNTS["all_reduce"] - before
            out["design"] = counts["forward"] + counts["backward"] + 1
            for h in handles:
                h.remove()
            times = []
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out["host_ms"] = float(np.median(times))
            events = next(cs._sessions(step, 4, 1))
            nccl = [e for e in events if "nccl" in e.key.lower()]
            out["device_ms"] = sum(e.device_time_total for e in events) / 4 / 1e3
            out["nccl_ms"] = sum(e.device_time_total for e in nccl) / 4 / 1e3
            out["nccl_kernels"] = sum(e.count for e in nccl) / 4
            out["f64"] = _f64_step(group, world)
        torch.save(out, Path(work) / f"w{world}.rank{rank}.pt")
    finally:
        import torch.distributed as tdist

        tdist.destroy_process_group()


def _f64_step(group, world: int) -> dict:
    """One float64 stage-2 ResNet18 step on this rank's F64_ROWS rows of a
    global batch of F64_ROWS x world (all of it without a group), each row
    augmented by B1 with the global batch's draw; the loss and the state
    after it, on the CPU."""
    import chip_smoke as cs
    from medseg_tpu_torch.data.synthetic import synthetic_cls
    from medseg_tpu_torch.ops.augment import augment_batch
    from medseg_tpu_torch.train import steps as S

    ds = synthetic_cls(n=F64_ROWS * world, img_size=cs.SIZE, seed=cs.SEED + 41)
    model, opt = cs._dp_resnet18(torch.float64)
    loss, _ = S.cls_train_step(
        model, opt, cs._dp_rows(ds.images, group), cs._dp_rows(ds.labels, group),
        torch.Generator(device="cuda").manual_seed(cs.SEED), 0.1,
        prep=lambda g, x, y: (augment_batch(g, x, out_dtype=torch.float32)[0].double(), y))
    return {"loss": loss.item(), "state": {k: v.cpu() for k, v in model.state_dict().items()
                                           if not k.endswith("num_batches_tracked")}}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=16, help="rows a rank")
    args = p.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.ranks:
        print(f"dp_scaling: needs {args.ranks} CUDA devices", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    import torch.multiprocessing as mp
    from medseg_tpu_torch.ops.kernels import build

    build.build_all()  # once, before the ranks load it
    card = cs.card_label()
    readings = {}
    with tempfile.TemporaryDirectory(dir=HERE / "build") as work:
        for world in sorted({1, args.ranks}):
            t0 = time.perf_counter()
            mp.spawn(_rank_main, args=(world, cs._free_port(), work, args.steps, args.batch),
                     nprocs=world, join=True)
            got = [torch.load(Path(work) / f"w{world}.rank{r}.pt", weights_only=False)
                   for r in range(world)]
            for r, g in enumerate(got):
                if g["all_reduce"] != g["design"] or g["device"] != f"cuda:{r}":
                    cs.fail(f"world {world}, rank {r}: {g['all_reduce']} all-reduces against "
                            f"the design's {g['design']}, on {g['device']}")
                same = g["f64"]["loss"] == got[0]["f64"]["loss"] and all(
                    torch.equal(v, got[0]["f64"]["state"][k]) for k, v in g["f64"]["state"].items())
                if not same:
                    cs.fail(f"world {world}: rank {r}'s float64 step differs from rank 0's")
            r0 = got[0]
            readings[world] = {k: r0[k] for k in ("all_reduce", "host_ms", "device_ms",
                                                  "nccl_ms", "nccl_kernels")}
            readings[world]["img_s"] = args.batch * world / (r0["host_ms"] / 1e3)
            print(f"[{card}] world {world}: {r0['all_reduce']} all-reduces a step (the "
                  f"design's {r0['design']}); a step {r0['host_ms']:.3f} ms of host (median of "
                  f"{args.steps}), {r0['device_ms']:.3f} ms of device, NCCL "
                  f"{r0['nccl_kernels']:g} kernels {r0['nccl_ms']:.4f} ms "
                  f"({100 * r0['nccl_ms'] / r0['device_ms']:.1f}%); "
                  f"{readings[world]['img_s']:.1f} img/s at B={args.batch} a rank; "
                  f"{time.perf_counter() - t0:.1f} s")
            if world > 1:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                one = _f64_step(None, world)
                loss = abs(r0["f64"]["loss"] - one["loss"]) / abs(one["loss"])
                worst = max((float((v - one["state"][k]).abs().max())
                             / max(float(one["state"][k].abs().max()), cs.DP_LR), k)
                            for k, v in r0["f64"]["state"].items())
                print(f"[{card}] ResNet18 float64, {world} NCCL ranks of B={F64_ROWS} against "
                      f"one process of B={F64_ROWS * world}: loss {r0['f64']['loss']} vs "
                      f"{one['loss']} (rel {loss:.3g}); after the step every parameter and "
                      f"running statistic within {worst[0]:.3g} of its largest ({worst[1]})")
                if loss > 1e-9 or worst[0] > 1e-9:
                    cs.fail(f"float64 parity over {world} NCCL ranks beyond 1e-9")
    print(f"card: {card}")
    print(json.dumps({"dp_scaling": readings, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
