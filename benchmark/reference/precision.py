"""The reference's precision: float32 with TF32 off, and the controls' roundings.

`float32()` is the block in which the reference computes: TF32 off in
cuBLAS and cuDNN, so a float32 product is a float32 product on the card.
The controls put the reference in the program's place at the precision
below the one its configuration states (configs/*.json `precision`), at
every point where the program rounds to its own compute dtype: each conv's
and transposed conv's operands and output, and each BatchNorm's output
(the head, the loss, the 1x1 output conv of the segmenter and BatchNorm's
statistics stay float32, as in the program):
- bfloat16 compute (the train cells) -> fp8: the forward's values scaled
  per tensor to e4m3's largest value (448), rounded to e4m3 and scaled
  back, and the backward's gradients the same way in e5m2 (largest 57344),
  as fp8 training does; products accumulate in float32;
- float32 under TF32 (the eval cell) -> bfloat16: values and gradients
  rounded to bfloat16, products accumulating in float32, as a bf16 model
  on tensor cores does.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def float32(tf32: bool = False):
    """TF32 off (on with tf32=True: the eval configuration's own
    precision, the yardstick of its compared number) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


E5M2_MAX = 57344.0


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _scaled(dtype, largest):
    def round_(t: torch.Tensor) -> torch.Tensor:
        scale = largest / t.abs().amax().clamp(min=1e-30)
        return (t * scale).to(dtype).to(t.dtype) / scale
    return round_


class _Round(torch.autograd.Function):
    """Round the values one way and their gradients another."""

    @staticmethod
    def forward(ctx, t, fwd, bwd):
        ctx.bwd = bwd
        return fwd(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.bwd(grad), None, None


_E4M3 = _scaled(torch.float8_e4m3fn, E4M3_MAX)
_E5M2 = _scaled(torch.float8_e5m2, E5M2_MAX)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return _Round.apply(t, _bf16, _bf16)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    return _Round.apply(t, _E4M3, _E5M2)


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


QUANT = {"float32": identity, "tf32": identity, "bfloat16": round_bf16, "fp8": round_fp8}
# the control of each stated precision: the nearest one below it
CONTROL = {"bfloat16": "fp8", "float32-tf32": "bfloat16"}
