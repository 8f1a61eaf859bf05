"""The numbers that decide `correct`, each against a limit of its cell
(limits/<cell>.json).

Training (the first steps of the object the window then trains):
- `loss_gap`: the largest |program - reference| / |reference| of the
  losses of the steps' groups (the eager first step; the mean of the first
  captured chunk's steps, which add into one accumulator);
- `grad_gap`: over the trainable leaves, the largest gap between the
  norm of the program's first gradient as its optimizer got it (clipped,
  averaged over the ranks; read from AdamW's first moment after one step)
  and the reference's, against the larger of the reference's norm of that
  leaf and of the median leaf; `grad_median_gap`: the median leaf's gap;
- `change_gap`, `change_median_gap`: the same of the parameters' change
  over the followed steps, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's (a conv bias under a
  training-mode BatchNorm has a gradient of 0 in exact arithmetic, and
  AdamW moves it by round-off alone).
Evaluation (every answer of every pass in the window):
- `logit_gap`: over every image of every pass, by how much the reference's
  logit of the program's predicted class lies below the reference's best,
  against the median spread (largest - smallest) of the reference's logits
  per image; a pass with a missing, extra or reordered image reads inf;
- `logit_rms_err`: the root mean square of the gaps between the logits the
  program's forwards returned and the reference's, against that spread (a
  widest gap of 4548 logits swings 5x from seed to seed; this does not).
A cell compares the numbers its limits file names.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence

import numpy as np

UNREADABLE = 1e300  # a number that could not be read (JSON has no infinity)
ZERO_GRAD = 1e-3  # a leaf's gradient under this share of the median leaf's is nought


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Iterable[str] = None) -> Dict[str, float]:
    """Each leaf's gap; every leaf reads inf when the leaves differ."""
    keys = sorted(ref if keep is None else keep)
    if set(prog) != set(ref):
        return {k: math.inf for k in keys}
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}



def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= ZERO_GRAD * med]


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref):
        return math.inf
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def train_numbers(prog: dict, ref: dict, head: Sequence[str] = ()) -> Dict[str, float]:
    """head: the leaves of the last layer (the configuration's
    `head_leaves`), whose gradient depends on the forward alone."""
    moving = moving_leaves(ref["grad"])
    grad = leaf_gaps(prog["grad"], ref["grad"])
    change = leaf_gaps(prog["change"], ref["change"], moving)
    out = {"loss_gap": loss_gap(prog["loss"], ref["loss"]),
           "grad_gap": max(grad.values()),
           "grad_median_gap": float(np.median(list(grad.values()))),
           "change_gap": max(change.values()),
           "change_median_gap": float(np.median(list(change.values())))}
    if head:
        own = {k: abs(prog["grad"].get(k, math.inf) - ref["grad"][k]) / ref["grad"][k]
               for k in head}
        out["head_grad_gap"] = max(own.values())
    return out


def logit_rms_err(ref_logits: np.ndarray, logits) -> float:
    """The root mean square of the gaps between the program's logits (each
    pass's, as its forwards returned them) and the reference's, against
    the median spread of the reference's logits per image; the worst pass."""
    spread = float(np.median(ref_logits.max(1) - ref_logits.min(1)))
    worst = 0.0
    for got in logits:
        got = np.asarray(got, dtype=np.float64)
        if got.shape != ref_logits.shape or not np.isfinite(got).all():
            return math.inf
        worst = max(worst, float(np.sqrt(np.mean((got - ref_logits) ** 2))) / spread)
    return worst if logits else math.inf


YARDSTICK_FLOOR = 1e-6  # a yardstick of 0 (no TF32, as on the CPU) reads as this


def logit_rms_ratio(ref_logits: np.ndarray, logits, yardstick: np.ndarray) -> float:
    """logit_rms_err of the program's logits over that of the reference
    computed at the configuration's own precision (TF32): how many times
    the configured rounding the program's logits are off.  The seed moves
    both alike (5x from seed to seed), not their ratio."""
    return logit_rms_err(ref_logits, logits) / max(logit_rms_err(ref_logits, [yardstick]),
                                                   YARDSTICK_FLOOR)


def logit_gap(ref_logits: np.ndarray, labels: np.ndarray, passes) -> float:
    """passes: [(preds, labels)] as the program's passes returned them."""
    spread = float(np.median(ref_logits.max(1) - ref_logits.min(1)))
    best = ref_logits.max(1)
    worst = 0.0
    for preds, got in passes:
        preds, got = np.asarray(preds), np.asarray(got)
        if preds.shape != labels.shape or not np.array_equal(got, labels):
            return math.inf
        if preds.min() < 0 or preds.max() >= ref_logits.shape[1]:
            return math.inf
        gap = best - ref_logits[np.arange(len(preds)), preds]
        worst = max(worst, float(gap.max()) / spread)
    return worst if passes else math.inf


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} of every number the limits name; one that
    is missing or not finite reads UNREADABLE."""
    out = {}
    for k, limit in limits.items():
        v = numbers.get(k, math.inf)
        out[k] = {"value": v if math.isfinite(v) else UNREADABLE, "limit": limit}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
