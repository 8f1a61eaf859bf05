#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, many seeds in one process.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 [--control]

For each seed: the program's numbers as a run computes them (the cell's
set-up and first steps, or one eval pass, against the float32 reference),
and with --control the control's: the reference at the precision below
the configuration's (reference/precision.py CONTROL) put in the program's
place, against the same float32 reference; for a training cell also the
faults planted in the reference put in the program's place (half of each
batch left out of the loss's mean; on a cell of several chips, the
exchange between them left out).  Prints one JSON line a seed and a
summary line: the largest program reading and the smallest reading of
the control and of each fault.  Cells on several chips read their
single-card form: the reference follows the global batch either way.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def train_readings(cell, seed: int, device, control: bool, world: int = 1) -> dict:
    from benchmark.drivers import train_epochs as T
    from benchmark.reference import steps as ref
    from benchmark.reference.precision import CONTROL

    t = T.Trainer(cell, seed, device)
    readings = t.first_steps()
    weights, arrays, gen_seed = t.weights, t.arrays, t.gen_seed
    t.free()
    look = {}
    out = {"program": T.check(cell, readings, weights, arrays, gen_seed, device, worst=look),
           "program_leaves": look}
    if control:
        prec = CONTROL[cell.config["recipe"]["compute_dtype"]]
        rows = readings["rows"]
        batches = T.batches(cell, rows, arrays, device)
        lr = T._lr(cell.config["recipe"], 1)
        planted = [("control", dict(precision=prec)), ("fault_half", dict(fault="half"))]
        if world > 1:
            planted.append(("fault_no_exchange", dict(fault="local", world=world)))
        for name, kw in planted:
            low = ref.follow(cell.config, weights, batches, gen_seed, readings["groups"], lr, **kw)
            look = {}
            out[name] = T.check(cell, dict(low, rows=rows, groups=readings["groups"]),
                                weights, arrays, gen_seed, device, worst=look)
            out[name + "_leaves"] = look
        out["control_precision"] = prec
    return out


def eval_readings(cell, seed: int, device, control: bool) -> dict:
    import torch

    from benchmark.drivers import eval_passes as E
    from benchmark.harness import compare
    from benchmark.reference import steps as ref
    from benchmark.reference.precision import CONTROL

    res = E.measure(cell, seed, 0.0, False, device, time.time())
    out = {"program": res.numbers}
    if control:
        from benchmark.harness import data as D

        cfg = cell.config
        arrays = D.dataset("classification", cfg["assumed"]["test_split"],
                           cfg["architecture"]["image_size"], cfg["assumed"]["class_counts"],
                           seed, device, E._DATA)
        from benchmark.harness import manifest

        weights = D.weights(manifest.reference(cfg).build(cfg, "meta"), seed, device,
                            E._WEIGHTS)
        images = torch.from_numpy(arrays["images"]).to(device)
        prec = CONTROL["float32-tf32"]
        low = ref.logits(cfg, weights, images, prec).cpu().numpy()
        hi = ref.logits(cfg, weights, images).cpu().numpy()
        yard = ref.logits(cfg, weights, images, "tf32").cpu().numpy()
        out["control"] = {"logit_gap": compare.logit_gap(hi, arrays["labels"],
                                                         [(low.argmax(1), arrays["labels"])]),
                          "logit_rms_err": compare.logit_rms_err(hi, [low]),
                          "logit_rms_ratio": compare.logit_rms_ratio(hi, [low], yard)}
        out["control_precision"] = prec
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args()
    import dataclasses

    import torch

    from benchmark.harness import manifest

    cell = manifest.cell(args.workload)
    world = cell.chips
    cell = dataclasses.replace(cell, chips=1,
                               traffic=dict(cell.traffic, batch_per_chip=cell.traffic["batch_per_chip"]
                                            * cell.chips))
    device = torch.device("cuda", 0)
    kind = "eval" if cell.traffic["driver"] == "eval_passes" else "train"
    worst, best = {}, {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        if kind == "eval":
            r = eval_readings(cell, seed, device, args.control)
        else:
            r = train_readings(cell, seed, device, args.control, world)
        for k, v in r["program"].items():
            worst[k] = max(worst.get(k, 0.0), v)
        for planted in ("control", "fault_half", "fault_no_exchange"):
            for k, v in r.get(planted, {}).items():
                best.setdefault(planted, {})
                best[planted][k] = min(best[planted].get(k, float("inf")), v)
        print(json.dumps({"seed": seed, "s": round(time.time() - t0, 1), **r}), flush=True)
    print(json.dumps({"workload": args.workload, "program_max": worst, "planted_min": best,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
