"""The warp kernel's wrapper: uint8 NHWC images -> two-pass affine warp with
the optional fused photometric epilogue, on Hopper.

Replaces medseg_tpu/ops/pallas/warp_kernel.py:208 `warp_affine_pallas` (body
`_warp_kernel`), the one TPU kernel on the aug+infer path.  The CUDA source
is medseg_tpu_torch/csrc/warp_affine.cu: a CTA owns a 64x64 output tile,
stages the window of source rows the tile reads in shared memory, computes
each pass-A value once per (row, column, channel) into shared memory, then
runs pass B and the epilogue into an output tile that it copies out with
16-byte stores.  Its bound is memory (each input byte read once, each output
written once: 75.5 MB at B=128, 256x256x3 with bf16 out, about 23 us at
3.35 TB/s); the latency of its phases, which run one after another, limits
this design.  Its plain PyTorch version is ops/warp_fast.warp_affine_fast,
with which it agrees bit for bit in float32, for any matrix.

For a CPU tensor the wrapper runs the plain version.  For a CUDA tensor it
launches the kernel or raises; it never falls back.  `planar=True` returns
the JAX kernel's [B, C*H, W] layout (channel-major rows), which the kernel
writes directly; the fused stem (ops/kernels/stem_kernel.py) reads it.

The launch goes to the current stream, so a CUDA graph capture records it
(train/steps.ScanDrive); the first call, which builds the library and sets
the kernel's shared-memory attribute, must come before the capture.
`warp_affine_kernel.launches` counts the wrapper's launches: a captured
launch is counted once, when it is recorded, and its replays are not;
count a graphed path's launches from the profiler's device records.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from medseg_tpu_torch.ops.warp_fast import warp_affine_fast, warp_scalars

SOURCE = "warp_affine.cu"
REPLACES = "medseg_tpu/ops/pallas/warp_kernel.py:208"
MAX_CHANNELS = 4
_FloatArray = ctypes.c_float * MAX_CHANNELS


@functools.lru_cache(maxsize=None)
def _launcher():
    from medseg_tpu_torch.ops.kernels.build import load_library

    fn = load_library(SOURCE).cdll.medseg_warp_affine_u8
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_float)] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(images, matrices, out_dtype, alpha, beta, mean, std):
    if images.dtype != torch.uint8 or images.dim() != 4:
        raise ValueError(f"images must be uint8 [B,H,W,C], got "
                         f"{images.dtype} {tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous")
    b, h, w, c = images.shape
    if not (1 <= b <= 65535 and h >= 2 and w >= 2 and 1 <= c <= MAX_CHANNELS):
        raise ValueError(f"unsupported images shape {tuple(images.shape)}")
    if (matrices.shape != (b, 2, 3) or matrices.dtype != torch.float32
            or matrices.device != images.device):
        raise ValueError(f"matrices must be float32 [{b},2,3] on "
                         f"{images.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if (mean is None) != (std is None):
        raise ValueError("mean and std go together")
    if mean is not None:
        if len(mean) != c or len(std) != c:
            raise ValueError(f"mean/std need {c} values")
        for v in (alpha, beta):
            if (v is None or v.shape != (b,) or v.device != images.device):
                raise ValueError(f"the epilogue needs alpha and beta [{b}] on "
                                 f"{images.device}")


def warp_affine_kernel(images: torch.Tensor, matrices: torch.Tensor,
                       nearest: bool = False, out_dtype=torch.float32,
                       alpha: Optional[torch.Tensor] = None,
                       beta: Optional[torch.Tensor] = None,
                       mean: Optional[Sequence[float]] = None,
                       std: Optional[Sequence[float]] = None,
                       planar: bool = False) -> torch.Tensor:
    """Two-pass warp of uint8 [B,H,W,C] images by dst->src matrices [B,2,3].

    Arguments as in JAX's warp_affine_pallas: with alpha/beta [B] and
    per-channel mean/std on the 0..255 scale, the epilogue
    clip(x*alpha + 255*beta, 0, 255), then (x - mean_c)/std_c, runs in the
    same pass.  Returns [B,H,W,C], or [B,C*H,W] when `planar`, in
    `out_dtype` (float32 or bfloat16).
    """
    if images.device.type == "cpu":
        return warp_affine_fast(images, matrices, nearest, out_dtype,
                                alpha, beta, mean, std, planar)
    if images.device.type != "cuda":
        raise ValueError(f"no warp kernel for device {images.device}")
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        out = _run(_launcher(), stream, images, matrices, nearest, out_dtype,
                   alpha, beta, mean, std, planar)
    warp_affine_kernel.launches += 1
    return out


warp_affine_kernel.launches = 0


def _run(launch, stream, images, matrices, nearest, out_dtype, alpha, beta,
         mean, std, planar):
    """The CUDA branch with its launcher and stream given: validate, pack
    the per-sample scalars, allocate the output on the images' device and
    launch.  The CPU tests pass a host build of the source here."""
    _check(images, matrices, out_dtype, alpha, beta, mean, std)
    b, h, w, c = images.shape
    epilogue = mean is not None
    extra = (torch.stack([alpha, beta], -1).to(torch.float32) if epilogue
             else torch.zeros(b, 2, device=images.device))
    scalars = torch.cat([warp_scalars(matrices), extra], -1).contiguous()
    shape = (b, c * h, w) if planar else (b, h, w, c)
    out = torch.empty(shape, dtype=out_dtype, device=images.device)
    err = launch(images.data_ptr(), scalars.data_ptr(), out.data_ptr(),
                 b, h, w, c, int(nearest), int(out_dtype == torch.bfloat16),
                 int(epilogue), int(planar), _FloatArray(*(mean or ())),
                 _FloatArray(*(std or ())), stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed with CUDA error {err}")
    return out
