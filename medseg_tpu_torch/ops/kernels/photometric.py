"""The photometric kernel's wrapper: uint8 NHWC images -> per-sample flip,
brightness/contrast and normalization in one pass, on Hopper.

Replaces medseg_tpu/ops/pallas/photometric.py:51 `fused_photometric` (body
`_kernel`).  The CUDA source is medseg_tpu_torch/csrc/photometric.cu: a
thread owns a run of 8 pixels of a row, read with 8-byte loads, the flip a
reversal in registers, and each warp writes its 32 runs out of shared
memory with 16-byte stores, 512 contiguous bytes an instruction; other
widths and misaligned tensors take a scalar path inside the same kernel.
It is bound by memory (125.8 MB at B=128, 256x256x3 with float32 out,
37.6 us at 3.35 TB/s).  Its plain PyTorch version is
`fused_photometric_reference` below, with which it agrees bit for bit.

alpha, beta and flip all None is the eval form, (x - mean)/std: the same
bits as alpha=1, beta=0 and no flip, with no per-sample tensors to build.
On the card, `preprocess_eval_batch` is one launch of that form
(ops/augment.py).  For a CPU tensor the wrapper runs the plain version.
For a CUDA tensor it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from medseg_tpu_torch.core.config import IMAGENET_MEAN, IMAGENET_STD

SOURCE = "photometric.cu"
REPLACES = "medseg_tpu/ops/pallas/photometric.py:51"
MAX_CHANNELS = 4
_FloatArray = ctypes.c_float * MAX_CHANNELS


@functools.lru_cache(maxsize=None)
def _launcher():
    from medseg_tpu_torch.ops.kernels.build import load_library

    fn = load_library(SOURCE).cdll.medseg_fused_photometric_u8
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _scaled(values: Sequence[float], device) -> torch.Tensor:
    """Per-channel constants on the 0..255 scale, rounded to float32 first
    and multiplied in float32, as JAX's fused_photometric computes them."""
    return torch.tensor(values, dtype=torch.float32, device=device) * 255.0


@functools.lru_cache(maxsize=None)
def _norm_arrays(mean: tuple, std: tuple):
    """The kernel's mean/std arguments: the float32 values of _scaled."""
    return (_FloatArray(*_scaled(mean, "cpu").tolist()),
            _FloatArray(*_scaled(std, "cpu").tolist()))


def fused_photometric_reference(images: torch.Tensor, alpha: Optional[torch.Tensor],
                                beta: Optional[torch.Tensor], flip: Optional[torch.Tensor],
                                out_dtype=torch.float32,
                                mean: Sequence[float] = IMAGENET_MEAN,
                                std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """The kernel's plain PyTorch version, in the kernel's operation order;
    alpha, beta and flip all None is the eval form (x - mean)/std."""
    x = images.to(torch.float32)
    if alpha is not None:
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        x = x * alpha.to(torch.float32)[:, None, None, None] \
            + beta.to(torch.float32)[:, None, None, None] * 255.0
        x = x.clamp(0.0, 255.0)
    dev = images.device
    return ((x - _scaled(mean, dev)) / _scaled(std, dev)).to(out_dtype)


def _check(images, alpha, beta, flip, out_dtype, mean, std):
    if images.dtype != torch.uint8 or images.dim() != 4:
        raise ValueError(f"images must be uint8 [B,H,W,C], got "
                         f"{images.dtype} {tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous")
    b, h, w, c = images.shape
    if not (1 <= b <= 65535 and h >= 1 and w >= 1 and 1 <= c <= MAX_CHANNELS):
        raise ValueError(f"unsupported images shape {tuple(images.shape)}")
    scalars = {"alpha": alpha, "beta": beta, "flip": flip}
    given = [name for name, v in scalars.items() if v is not None]
    if given and len(given) != len(scalars):
        raise ValueError(f"alpha, beta and flip are given together or all None "
                         f"(the eval form), got only {given}")
    for name in given:
        v = scalars[name]
        if v.shape != (b,) or v.device != images.device:
            raise ValueError(f"{name} must be [{b}] on {images.device}")
    if flip is not None and flip.dtype != torch.bool:
        raise ValueError(f"flip must be bool, got {flip.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if len(mean) != c or len(std) != c:
        raise ValueError(f"mean/std need {c} values")


def fused_photometric(images: torch.Tensor, alpha: Optional[torch.Tensor],
                      beta: Optional[torch.Tensor], flip: Optional[torch.Tensor],
                      out_dtype=torch.float32,
                      mean: Sequence[float] = IMAGENET_MEAN,
                      std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """uint8 [B,H,W,C] images; alpha/beta [B] floats; flip [B] bool; or
    all three None for the eval form (alpha=1, beta=0, no flip).

    Returns (clip(x'*alpha + 255*beta, 0, 255) - 255*mean_c)/(255*std_c) as
    [B,H,W,C] in `out_dtype` (float32 or bfloat16), x' the image flipped
    horizontally where `flip` is set.  mean/std are on the 0..1 scale, as in
    AugmentConfig.
    """
    if images.device.type == "cpu":
        return fused_photometric_reference(images, alpha, beta, flip,
                                           out_dtype, mean, std)
    if images.device.type != "cuda":
        raise ValueError(f"no photometric kernel for device {images.device}")
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        out = _run(_launcher(), stream, images, alpha, beta, flip, out_dtype,
                   mean, std)
    fused_photometric.launches += 1
    return out


fused_photometric.launches = 0


def _run(launch, stream, images, alpha, beta, flip, out_dtype, mean, std):
    """The CUDA branch with its launcher and stream given: validate,
    allocate the output on the images' device and launch, with null
    per-sample pointers for the eval form.  The CPU tests pass a host build
    of the source here."""
    _check(images, alpha, beta, flip, out_dtype, mean, std)
    b, h, w, c = images.shape
    ptrs = (None, None, None)  # null pointers: the eval form
    if alpha is not None:
        # float32 [B] tensors pass as they are, with no device operation
        scalars = (alpha.to(torch.float32).contiguous(),
                   beta.to(torch.float32).contiguous(), flip.contiguous())
        ptrs = tuple(v.data_ptr() for v in scalars)
    out = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    mean_arr, std_arr = _norm_arrays(tuple(mean), tuple(std))
    err = launch(images.data_ptr(), *ptrs, out.data_ptr(), b, h, w, c,
                 int(out_dtype == torch.bfloat16), mean_arr, std_arr, stream)
    if err != 0:
        raise RuntimeError(f"photometric kernel launch failed with CUDA error {err}")
    return out
