"""The card's published peaks and the least time of each kernel of the program.

Frozen copies of the bound functions of the repository's chip_smoke.py
(`bound_ms`, `warp_bound_ms`, `photometric_bound_ms`); the benchmark's
tests hold them against the originals.  Peaks: NVIDIA's data sheet for the
H100 SXM at its 700 W limit, dense rates without sparsity.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
PEAK_FLOPS = {"float32": F32_FLOPS_PER_S, "tf32": TF32_FLOPS_PER_S,
              "bfloat16": BF16_FLOPS_PER_S}


def bound_ms(n_bytes: float, flops: float, flops_per_s: float):
    """Least time on this card: the larger of the bytes over the HBM rate
    and the operations over the peak rate of their type.
    Returns (ms, "bytes"|"operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def warp_bound_ms(b: int, h: int, w: int, c: int, out_bytes: int):
    """The warp (B1): each uint8 input byte read and each output written once
    (in either layout), against the 16-tap weighted sum each output value
    needs (16 multiply-adds = 32 flops) plus the epilogue's 4, in float32
    outside the tensor cores."""
    values = b * h * w * c
    return bound_ms(values * (1 + out_bytes) + b * 8 * 4, values * (32 + 4),
                    F32_FLOPS_PER_S)


def photometric_bound_ms(b: int, h: int, w: int, c: int, out_bytes: int,
                         per_sample: bool = True):
    """The photometric pass (B2): each uint8 input byte read and each output
    written once (+ the per-sample alpha, beta and flip, 9 bytes a sample),
    against 7 float32 flops per value; the eval form (per_sample False)
    reads no scalars and does 2 (subtract, divide)."""
    values = b * h * w * c
    return bound_ms(values * (1 + out_bytes) + (b * 9 if per_sample else 0),
                    values * (7 if per_sample else 2), F32_FLOPS_PER_S)
