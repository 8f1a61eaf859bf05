"""Host-side LR schedules with torch semantics.

A copy of medseg_tpu/train/schedules.py, which imports no JAX; the port
keeps its own.  The reference steps its schedulers once per epoch on the
host (utils/helpers.py:383-392), and so do both trainers: the epoch LR is
computed here and written into the optimizer's param groups.
"""

from __future__ import annotations

import math


def cosine_annealing(lr0: float, epoch: int, t_max: int, eta_min: float = 0.0) -> float:
    """torch CosineAnnealingLR value at `epoch` steps after start (epoch 0 = lr0)."""
    return eta_min + (lr0 - eta_min) * (1 + math.cos(math.pi * epoch / t_max)) / 2


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau (mode='max', rel threshold 1e-4) semantics
    (reference utils/helpers.py:307-309: factor=0.1, patience=3)."""

    def __init__(self, lr: float, mode: str = "max", factor: float = 0.1,
                 patience: int = 3, threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = -math.inf if mode == "max" else math.inf
        self.num_bad = 0

    def _is_better(self, score: float) -> bool:
        # torch's rel-threshold formula, unconditionally (torch applies it
        # regardless of best's sign; best starts at -/+inf so the first
        # finite score always updates).
        if self.mode == "max":
            return score > self.best * (1.0 + self.threshold)
        return score < self.best * (1.0 - self.threshold)

    def step(self, score: float) -> float:
        """Record an epoch score; returns the (possibly reduced) LR."""
        if self._is_better(score):
            self.best = score
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr


class EarlyStopping:
    """Best-score tracking + patience (reference utils/helpers.py:286-288,394-406)."""

    def __init__(self, patience: int = 10, mode: str = "max"):
        self.patience = patience
        self.mode = mode
        self.best = 0.0 if mode == "max" else math.inf
        self.counter = 0

    def update(self, score: float) -> bool:
        """Returns True if this is a new best (checkpoint trigger)."""
        improved = score > self.best if self.mode == "max" else score < self.best
        if improved:
            self.best = score
            self.counter = 0
        else:
            self.counter += 1
        return improved

    @property
    def should_stop(self) -> bool:
        return self.counter >= self.patience
