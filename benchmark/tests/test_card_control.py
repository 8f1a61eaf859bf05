"""On the card, at each cell's own size: the program's numbers pass their
limits and the control's (the reference a precision below the
configuration's, in the program's place) fail one, on three seeds.

    python -m pytest benchmark/tests/test_card_control.py -m card
"""

import dataclasses

import pytest

from benchmark.harness import compare, manifest

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def _single_card(name):
    c = manifest.cell(name)
    return dataclasses.replace(c, chips=1, traffic=dict(
        c.traffic, batch_per_chip=c.traffic["batch_per_chip"] * c.chips))


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in manifest.load()["workloads"]])
def test_program_passes_and_control_fails(card, name):
    from benchmark.tools import readings

    c = _single_card(name)
    lim = c.limits
    read = readings.eval_readings if c.traffic["driver"] == "eval_passes" else readings.train_readings
    for seed in SEEDS:
        r = read(c, seed, card, True)
        assert compare.passed(compare.judge(r["program"], lim)), (seed, r)
        assert not compare.passed(compare.judge(r["control"], lim)), (seed, r)
