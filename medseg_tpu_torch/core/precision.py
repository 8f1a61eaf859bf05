"""Precision policy: parameters and BN statistics in float32, conv/matmul
compute in bfloat16, outputs in float32.  bfloat16 shares float32's exponent
range, so no loss scaling is needed."""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def full_float32():
    """TF32 off in cuBLAS and cuDNN inside the block, the flags restored
    after: the CLIP recipes run "full fp32" (medseg_tpu/train/
    clip_finetune.py:7), and cuDNN would take TF32 for CLIPSeg's decoder
    convs by default."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
