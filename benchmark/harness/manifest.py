"""BENCHMARK.json and the files it names: cells, configurations, traffic,
drivers and per-layer readers, each found by its name.

- a configuration: the file its entry names (configs/<name>.json);
- a configuration's plain reference and FLOP count: the modules its
  `reference` and `flops` keys name;
- a traffic mix: traffic/<traffic>.json, whose "driver" names the driver,
  drivers/<driver>.py, a module with
  `run(cell, seed, seconds, trace, device, t_start) -> result`;
- a cell's limits: limits/<cell>.json, the limits of its compared numbers;
- a per-layer metric: metrics/<metric name>.py, a module with
  `read(ctx) -> float | None` (None: nothing to read in this cell); a
  metric split by kind of cell (`device_idle.train`, `device_idle.eval`)
  may share the reader of the name before its first dot
  (metrics/device_idle.py).
A later change adds a cell, a configuration, a mix or a metric by adding
such files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]  # benchmark/
ROOT = HERE.parent                          # the checkout
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@dataclass
class Cell:
    name: str
    chips: int
    config: dict       # configs/<name>.json
    traffic: dict      # traffic/<traffic>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]  # limits/<name>.json


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _for(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: dict = None) -> Cell:
    """A cell of `manifest` (BENCHMARK.json)."""
    m = manifest or load()
    by = {w["name"]: w for w in m["workloads"]}
    if name not in by:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(by)})")
    w = by[name]
    cfg_entry = next(c for c in m["configs"] if c["name"] == w["config"])
    with open(ROOT / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)["limits"]
    return Cell(name, w["chips"], config, traffic,
                [e for e in m["end_to_end"] if _for(e, name)],
                [p for p in m["per_layer"] if _for(p, name)], limits)


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.drivers.{name}")


def module_at(path) -> ModuleType:
    """The module of a file of the benchmark, by its path from the checkout's
    root (a configuration's `reference` and `flops`, a metric's reader)."""
    path = ROOT / path
    name = "benchmark._" + re.sub(r"\W", "_", str(path.relative_to(HERE).with_suffix("")))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> ModuleType:
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return module_at(path)


def reference(config: dict) -> ModuleType:
    """The configuration's plain reference model module (`build`, `set_quant`)."""
    return module_at(config["reference"])


def flop_count(config: dict) -> ModuleType:
    """The configuration's FLOP count module (`forward_flops`, `train_flops`)."""
    return module_at(config["flops"])


def problems(m: dict) -> List[str]:
    """What in the manifest breaks the contract's rules of form."""
    out = []
    if set(m) != TOP_KEYS:
        out.append(f"top-level keys {sorted(m)}")
    e2e = {e["name"]: e for e in m["end_to_end"]}
    cells = {w["name"]: w for w in m["workloads"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[group]]
        out += [f"{n} named twice" for n in set(names) if names.count(n) > 1]
        for e in m[group]:
            if not NAME.match(e["name"]):
                out.append(f"name {e['name']!r}")
            if "unit" in e and not UNIT.match(e["unit"]):
                out.append(f"unit {e['unit']!r} of {e['name']}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                out.append(f"better of {e['name']}")
            for c in e.get("workloads", ()):
                if c not in cells:
                    out.append(f"{e['name']} lists unknown cell {c}")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for e in m["end_to_end"]:
        if e["source"] not in SOURCES_E2E:
            out.append(f"source of {e['name']}")
        if not 0.01 <= e["bound"] <= 0.25:
            out.append(f"bound of {e['name']}")
    for p in m["per_layer"]:
        if p["source"] not in SOURCES:
            out.append(f"source of {p['name']}")
        moved = e2e.get(p["moves"])
        if moved is None or moved["name"] == "setup_s":
            out.append(f"{p['name']} moves {p['moves']}")
            continue
        for c in p.get("workloads", cells):
            if not _for(moved, c):
                out.append(f"{p['name']} in {c}, which does not report {p['moves']}")
    for c in cells:
        reported = [e for e in m["end_to_end"] if _for(e, c)]
        if len(reported) < 2 or not any(_for(p, c) for p in m["per_layer"]):
            out.append(f"cell {c} reports too little")
    four = sum(w["chips"] == 4 for w in m["workloads"])
    if four > max(1, len(cells) // 4):
        out.append(f"{four} cells on four chips")
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    if len(set(pairs)) != len(pairs):
        out.append("a configuration and traffic pair twice")
    used = {w["config"] for w in m["workloads"]}
    out += [f"config {c['name']} used by no cell" for c in m["configs"] if c["name"] not in used]
    return out
