"""Each driver at a tiny size on the CPU: a result line of the contract's
form, the same numbers from the same seed, and the compared numbers within
their limits when the program computes in float32 (the precision of the
reference).  The cells' own bf16 runs are judged on the card."""

import dataclasses
import json
import time

import pytest
import torch

from benchmark.harness import manifest
from benchmark.tests import tiny

CPU = torch.device("cpu")


def _run(c, seed=2**33 + 5, trace=False):
    with tiny.card_branch():
        return manifest.driver(c.traffic["driver"]).run(c, seed, 0.01, trace, CPU, time.time())


def _f32(c):
    if "recipe" in c.config:
        c.config["recipe"]["compute_dtype"] = "float32"
    return c


@pytest.mark.parametrize("name", ["resnet18-train-b128", "resnetunet-train", "resnet18-eval"])
def test_single_chip_drivers(name):
    c = _f32(tiny.cell(name))
    r = _run(c)
    assert list(r)[-1] == "checks" and r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {e["name"] for e in c.end_to_end}
    assert r["device"]["count"] == 1 and r["attempted"] > 0 and r["failed"] == 0
    again = _run(c)
    assert again["checks"] == r["checks"]  # the same inputs from the same seed
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("name", ["resnet18-train-b128", "resnet18-eval"])
def test_traced_run_reads_per_layer_metrics(name):
    c = _f32(tiny.cell(name))
    r = _run(c, trace=True)
    assert r["correct"] is True
    assert set(r["metrics"]) <= {p["name"] for p in c.per_layer}
    assert r["device"]["window_s"] > 0 and "breakdown" in r
    assert list(r)[-1] == "checks"


def test_data_parallel_driver_over_two_gloo_ranks():
    c = _f32(tiny.dp_cell(train_split=40))
    r = _run(c)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["count"] == 2 and list(r)[-1] == "checks"


@pytest.mark.parametrize("name", [w["name"] for w in manifest.load()["workloads"]]
                         + sorted(tiny.BUILT))
def test_every_cell_has_limits(name):
    """Every cell's limits name numbers its driver computes, each above 0."""
    known = {"eval_passes": {"logit_gap", "logit_rms_err", "logit_rms_ratio"}}
    train = {"loss_gap", "grad_gap", "grad_median_gap", "change_gap", "change_median_gap",
             "head_grad_gap"}
    c = tiny.full(name)
    assert c.limits and set(c.limits) <= known.get(c.traffic["driver"], train), c.limits
    assert all(v > 0 for v in c.limits.values())
