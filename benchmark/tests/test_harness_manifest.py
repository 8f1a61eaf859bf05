"""BENCHMARK.json keeps the contract's rules of form, and every file it
names is there."""

import json

import pytest

from benchmark.harness import manifest


def test_manifest_is_sound():
    assert manifest.problems(manifest.load()) == []


def test_every_named_file_is_there():
    m = manifest.load()
    for c in m["configs"]:
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert (manifest.ROOT / cfg["reference"]).exists()
    for w in m["workloads"]:
        cell = manifest.cell(w["name"], m)
        assert manifest.driver(cell.traffic["driver"]).run
        assert cell.limits
        assert len(w["why"]) <= 200
    for p in m["per_layer"]:
        assert manifest.reader(p["name"]).read


def test_a_split_metric_shares_its_reader():
    assert manifest.reader("device_idle.train") is manifest.reader("device_idle.eval")


def _eval_metric(m):
    m["end_to_end"].insert(0, {"name": "eval_img_per_s", "unit": "img/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": []})


def _second_cell(m, chips):
    m["workloads"][0]["chips"] = chips
    m["workloads"].append(dict(m["workloads"][0], name="again", traffic="other"))
    for e in m["end_to_end"] + m["per_layer"]:
        if "workloads" in e:
            e["workloads"].append("again")


@pytest.mark.parametrize("breakage, found", [
    (lambda m: m["end_to_end"][0].update(unit="img per s"), "unit"),
    (lambda m: m["per_layer"][0].update(name="train mfu"), "name"),
    (lambda m: (_eval_metric(m), m["per_layer"][0].update(moves="eval_img_per_s")),
     "does not report"),
    (lambda m: m["per_layer"][0].update(moves="setup_s"), "moves"),
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m: m["end_to_end"].pop(), "setup_s"),
    (lambda m: _second_cell(m, 4), "four chips"),  # two of two
    (lambda m: m["workloads"].append(dict(m["workloads"][0], name="again")), "pair"),
    (lambda m: m["per_layer"][0].update(workloads=["nowhere"]), "unknown cell"),
])
def test_problems_are_found(breakage, found):
    broken = manifest.load()
    breakage(broken)
    assert any(found in p for p in manifest.problems(broken)), manifest.problems(broken)


def test_a_second_single_card_cell_is_sound():
    m = manifest.load()
    _second_cell(m, 1)
    assert manifest.problems(m) == []
