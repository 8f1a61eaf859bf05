"""Precision policy: parameters and BN statistics in float32, conv/matmul
compute in bfloat16, outputs in float32.  bfloat16 shares float32's exponent
range, so no loss scaling is needed."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


def policy_from_name(name: str) -> Policy:
    """TrainConfig.compute_dtype -> Policy (medseg_tpu/core/precision.py:24)."""
    if name in ("bfloat16", "bf16", "mixed"):
        return Policy()
    if name in ("float32", "fp32", "full"):
        return Policy(compute_dtype=torch.float32)
    raise ValueError(f"Unknown precision policy: {name}")
