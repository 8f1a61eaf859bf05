"""Tracing / profiling hooks.

Counterpart of medseg_tpu/utils/profiling.py:
- `trace_context`: a torch.profiler scope writing a Chrome trace
  (`<host>_<pid>.<ms>.pt.trace.json`, loadable by TensorBoard's PyTorch
  profiler plugin and by chrome://tracing or Perfetto) into a directory, the
  counterpart of jax.profiler.start_trace / stop_trace;
- `StepTimer`: per-step wall-clock statistics with warmup discard.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import torch


@contextlib.contextmanager
def trace_context(log_dir: Optional[str], device=None):
    """Profile the enclosed block with torch.profiler when log_dir is set.
    The host's operators are always recorded; the card's kernels and copies
    too when `device` is the card (None: the card, as the entry points) and
    one is present, so a CPU run asks for no CUDA activity."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if (device is None or torch.device(device).type == "cuda") and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    @property
    def steady(self) -> List[float]:
        return self.times[self.warmup:]

    def mean(self) -> float:
        s = self.steady
        return sum(s) / len(s) if s else float("nan")

    def summary(self, items_per_step: int = 1) -> str:
        m = self.mean()
        return (f"steps={len(self.times)} mean={m * 1e3:.2f}ms "
                f"throughput={items_per_step / m:.1f}/s" if self.steady
                else "no steady-state samples")
