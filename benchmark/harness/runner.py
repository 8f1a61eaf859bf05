"""From a driver's outcome to the run's result line.

A driver returns an `Outcome`: the end-to-end values it took by host clock,
the counters its per-layer readers need, the traced session (with
--trace 1), the numbers compared with the reference, and the work done.
`finish` reads each per-layer metric of the cell through its reader
(metrics/<name>.py), judges the numbers against the cell's limits
(`cell.limits`, from limits/<cell>.json), and returns the result:
`correct`, `attempted`, `failed`, `metrics`, `device`, `breakdown`
(traced) and, last, `checks`.
"""

from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from benchmark.harness import compare, guard, manifest
from benchmark.harness.trace import Session


@dataclass
class Outcome:
    e2e: Dict[str, float]
    counters: Dict[str, float]
    numbers: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    session: Optional[Session] = None
    busy_s: Optional[float] = None   # averaged over the chips, if traced


@dataclass
class Context:
    """What a per-layer reader reads."""
    cell: manifest.Cell
    session: Session
    counters: Dict[str, float]


class SetupLog:
    """Seconds of each set-up phase, printed on standard error with the
    port's kernel libraries and whether this run built them (nvcc) or
    loaded them as an earlier run built them."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.last = t_start
        self.phases = []

    def mark(self, name: str) -> None:
        now = time.time()
        self.phases.append((name, now - self.last))
        self.last = now

    def print(self) -> None:
        parts = ", ".join(f"{n} {s:.2f} s" for n, s in self.phases)
        print(f"set-up: {time.time() - self.t_start:.2f} s ({parts})", file=sys.stderr)
        build_dir = manifest.ROOT / "build" / "medseg_tpu_torch"
        for so in sorted(build_dir.glob("lib*.so")):
            how = "built by this run" if so.stat().st_mtime >= self.t_start else "loaded"
            print(f"set-up: kernel library {so.relative_to(manifest.ROOT)} {how}",
                  file=sys.stderr)


def device_info(device: torch.device, chips: int, peak: int) -> dict:
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": int(peak)}


def per_layer(cell: manifest.Cell, session: Session, counters) -> Dict[str, dict]:
    ctx = Context(cell, session, counters)
    out = {}
    for m in cell.per_layer:
        value = manifest.reader(m["name"]).read(ctx)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"{m['name']} read {value}")
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def finish(cell: manifest.Cell, out: Outcome, trace: bool, device: torch.device) -> dict:
    if trace:
        metrics = per_layer(cell, out.session, out.counters)
    else:
        units = {e["name"]: e["unit"] for e in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out.e2e.items() if k in units}
    checks = compare.judge(out.numbers, cell.limits)
    result = {"correct": compare.passed(checks), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics,
              "device": device_info(device, cell.chips, out.memory_peak_bytes)}
    if trace:
        s = out.session
        result["device"]["busy_s"] = out.busy_s if out.busy_s is not None else s.busy_s
        result["device"]["window_s"] = s.window_s
        result["breakdown"] = {"device_ops": s.top_ops(), "idle_gaps": s.idle_gaps()}
    result["readings"] = out.numbers
    result["checks"] = checks
    return result


def emit(result: dict) -> int:
    """Print the checks on standard error and the result as the last line
    of standard output; 0, or 1 when a forbidden module was loaded (then
    nothing is printed)."""
    found = guard.forbidden()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}", file=sys.stderr)
        return 1
    for name, v in result.pop("readings", {}).items():
        if name not in result["checks"]:
            print(f"reading {name}: {v!r} (not compared)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
