"""The traced window: one torch.profiler session, read from its raw events.

The device's operations (kernels, copies, sets) come from the session's
Kineto events, as the repository's chip_smoke.py reads them, without
building the profiler's Python event tree (tens of seconds for a window of
training steps).  Host events (ATen operations, CUDA runtime calls, and
the benchmark's own spans, named "bench:...") label the idle gaps: a gap
takes the name of the innermost benchmark span that covers its start and
of the host event that overlaps it most.

Spans: `span(name)` records a range while a session is open and costs
nothing otherwise.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple

import torch

SPAN_PREFIX = "bench:"


class Op(NamedTuple):
    name: str
    start: int  # ns
    end: int


class Session:
    """Profile the block's device work on the current device: `ops` (device
    operations), `host` (host events), `window_s` (host clock from the
    synchronization before the block to the one after), `busy_s` (the
    union of the device operations' intervals)."""

    def __init__(self, device: torch.device, enabled: bool = True):
        self.device = device
        self.enabled = enabled
        self.ops: List[Op] = []
        self.host: List[Op] = []
        self.window_s = 0.0
        self._prof = None
        self._t0 = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._sync()
            self._prof.__enter__()
        _ACTIVE.append(self)
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        _ACTIVE.remove(self)
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self._read(self._prof.profiler.kineto_results.events())
            self._prof = None
        return False

    def _read(self, events) -> None:
        from torch.autograd import DeviceType

        for e in events:
            if e.is_hidden_event():
                continue
            op = Op(e.name(), e.start_ns(), e.end_ns())
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation() and op.end > op.start:
                    self.ops.append(op)
            elif e.device_type() == DeviceType.CPU:
                self.host.append(op)
        self.ops.sort(key=lambda o: o.start)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _union(self.ops)) / 1e9

    def device_time(self, match) -> float:
        """Seconds of device operations whose name satisfies match(name)."""
        return sum(o.end - o.start for o in self.ops if match(o.name)) / 1e9

    def count(self, match) -> int:
        return sum(1 for o in self.ops if match(o.name))

    def top_ops(self, n: int = 10):
        by = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0) + (o.end - o.start)
        return [[k[:120], v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """The n longest gaps between device operations inside the window,
        each named by what the host was doing then."""
        spans = _union(self.ops)
        gaps = [(e0, s1) for (_, e0), (s1, _) in zip(spans, spans[1:]) if s1 > e0]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._label(s, e), (e - s) / 1e9] for s, e in gaps[:n]]

    def _label(self, s: int, e: int) -> str:
        ours = [h for h in self.host if h.name.startswith(SPAN_PREFIX) and h.start <= s < h.end]
        inner = min(ours, key=lambda h: h.end - h.start).name if ours else "outside spans"
        best, over = None, 0
        for h in self.host:
            if h.name.startswith(SPAN_PREFIX):
                continue
            o = min(e, h.end) - max(s, h.start)
            if o > over:
                best, over = h.name, o
        return f"{inner} / {best or 'no host event'}"[:120]


def _union(ops: List[Op]):
    out = []
    for o in sorted(ops, key=lambda o: o.start):
        if out and o.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], o.end)
        else:
            out.append([o.start, o.end])
    return out


_ACTIVE: List[Session] = []


def span(name: str):
    """A named host range inside an open traced session (else a no-op)."""
    if _ACTIVE and _ACTIVE[-1].enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return contextlib.nullcontext()

