"""chip_smoke.py's gate 4 comparison (_compare_runs) on made-up runs: the
card's float32 distance from float64 is held to twice the CPU float32
runs' largest over the CPU's reduction orders, which are taken beyond the
first only when the card fails against it alone.  Pure arithmetic on
small tensors; no card and no model."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as C  # noqa: E402

OPTS = dict(card="card", path="zoo path, X", what="X", factor=2.0, card64=True,
            grad_floor=0.0, update_floor=0.0)


def _run(offset: float):
    """A run whose gradients, parameters and running statistics lie `offset`
    from the float64 reference's in one element: (losses, gradients,
    state, init)."""
    g = torch.tensor([0.5, -0.25, 0.125], dtype=torch.float64)
    p = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    s = torch.tensor([0.1, 0.2], dtype=torch.float64)
    bump = torch.tensor([offset, 0.0, 0.0], dtype=torch.float64)
    return ([0.5, 0.4, 0.3], {"w": g + bump},
            {"w": p + bump * 1e-3, "bn.running_mean": s + bump[:2]}, None)


def _runs(card: float, cpu: float, card64: float = 0.0):
    return {"card": _run(card), "cpu": _run(cpu), "float64": _run(0.0),
            "card float64": _run(card64)}


class _Orders:
    """more_cpu: the CPU float32 run at each thread count, counted."""

    def __init__(self, offsets: dict):
        self.offsets, self.asked = offsets, []

    def __call__(self, threads: int):
        self.asked.append(threads)
        return _run(self.offsets.get(threads, 0.0))


def _orders_taken(monkeypatch, threads=8):
    monkeypatch.setattr(torch, "get_num_threads", lambda: threads)
    return sorted({max(1, threads // d) for d in C.YARDSTICK_THREADS} - {threads},
                  reverse=True)


def test_card_within_the_first_order_takes_no_more(monkeypatch):
    _orders_taken(monkeypatch)
    more = _Orders({})
    lines, failure = C._compare_runs(_runs(1e-4, 1e-4), more_cpu=more, **OPTS)
    assert failure is None, lines
    assert more.asked == []
    assert not any("reduction orders" in line for line in lines)


def test_card_past_the_first_order_within_the_largest_passes(monkeypatch):
    taken = _orders_taken(monkeypatch)
    assert taken == [4, 2, 1]
    more = _Orders({2: 2e-4})  # the 2-thread order lands farther from float64
    lines, failure = C._compare_runs(_runs(3e-4, 1e-4), more_cpu=more, **OPTS)
    assert failure is None, lines
    assert more.asked == taken
    assert any("largest of 4 orders" in line for line in lines)


@pytest.mark.parametrize("offsets", [{}, {4: 1.4e-4, 1: 1.2e-4}])
def test_card_past_every_order_fails_and_names_the_parts(monkeypatch, offsets):
    _orders_taken(monkeypatch)
    more = _Orders(offsets)
    lines, failure = C._compare_runs(_runs(3e-4, 1e-4), more_cpu=more, **OPTS)
    assert failure is not None
    assert "float32 step-1 clipped gradients" in failure
    assert "float32 running statistics after step 3" in failure
    assert more.asked


def test_float64_fault_takes_no_more_orders(monkeypatch):
    _orders_taken(monkeypatch)
    more = _Orders({})
    lines, failure = C._compare_runs(_runs(1e-4, 1e-4, card64=1e-6), more_cpu=more, **OPTS)
    assert failure is not None and "float64 step-1 clipped gradients" in failure
    assert "float32" not in failure.split("(")[0]
    assert more.asked == []


def test_without_more_orders_the_first_is_the_yardstick(monkeypatch):
    _orders_taken(monkeypatch)
    lines, failure = C._compare_runs(_runs(3e-4, 1e-4), **OPTS)
    assert failure is not None and "float32 step-1 clipped gradients" in failure
