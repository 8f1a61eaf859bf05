"""The fused stem kernel's wrapper: planar images -> conv7x7/s2 + folded BN
+ ReLU + maxpool3x3/s2 in one pass, on Hopper.

Replaces medseg_tpu/ops/pallas/stem_kernel.py:191 `stem_conv_pool_pallas`
(body `_stem_kernel`), with `fold_bn` from the same file.  The CUDA source
is medseg_tpu_torch/csrc/stem_conv_pool.cu.  In bfloat16 (the stem path)
the conv is an implicit GEMM on the tensor cores (mma.sync m16n8k16, float32
accumulators): persistent CTAs walk 8x8 tiles of pooled outputs with all 64
channels, gather A fragments straight from a bf16 input patch in shared
memory (loaded by cp.async a tile ahead), hold the folded weights' B
fragments in registers, and pool from a bf16 conv tile.  The work bounds it
(39.5 GFLOP at B=128, 256x256: 40 us on the bf16 tensor cores); shared-memory
traffic of the A gathers limits this design.  float32 keeps a SIMT kernel
(TF32 tensor cores would miss its 1e-4 tolerance).  Its plain PyTorch
version is `stem_conv_pool_reference` below, a float32 convolution; the two
differ only in the order of the float32 sum.

Unlike the TPU kernel, the batch need not be even (that was a Mosaic
constraint).  H and W must be multiples of 4.  For a CPU tensor the wrapper
runs the plain version.  For a CUDA tensor it launches the kernel or raises;
it never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

SOURCE = "stem_conv_pool.cu"
REPLACES = "medseg_tpu/ops/pallas/stem_kernel.py:191"
OUT_CHANNELS = 64


@functools.lru_cache(maxsize=None)
def _launcher():
    from medseg_tpu_torch.ops.kernels.build import load_library

    fn = load_library(SOURCE).cdll.medseg_stem_conv_pool
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fold_bn(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = 1e-5):
    """BN(running stats) as y = x*g + b: g = scale/sqrt(var+eps)."""
    g = scale / torch.sqrt(var + eps)
    return g, bias - mean * g


def stem_conv_pool_reference(planes: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: planar [B,3H,W] images, folded
    weights [64,3,7,7] and bias [64], all in one dtype -> NHWC
    [B,H/4,W/4,64] in that dtype.  Computes in float32 (exact products of
    bfloat16 values), as the kernel does."""
    b, ch, w = planes.shape
    x = planes.to(torch.float32).reshape(b, 3, ch // 3, w)
    y = F.conv2d(x, weight.to(torch.float32), stride=2, padding=3)
    y = torch.relu(y + bias.to(torch.float32)[None, :, None, None])
    y = F.max_pool2d(y, 3, 2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous().to(planes.dtype)


def _check(planes, weight, bias):
    if planes.dim() != 3 or planes.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"planes must be float32 or bfloat16 [B,3H,W], got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    b, ch, w = planes.shape
    h = ch // 3
    if not (1 <= b <= 65535 and ch == 3 * h and h % 4 == 0 and w % 4 == 0
            and h >= 4 and w >= 4):
        raise ValueError(f"planes [B,3H,W] need H and W multiples of 4, got "
                         f"{tuple(planes.shape)}")
    for name, t, shape in (("weight", weight, (OUT_CHANNELS, 3, 7, 7)),
                           ("bias", bias, (OUT_CHANNELS,))):
        if (t.shape != shape or t.dtype != planes.dtype
                or t.device != planes.device):
            raise ValueError(f"{name} must be {planes.dtype} {list(shape)} on "
                             f"{planes.device}")
    for name, t in (("planes", planes), ("weight", weight), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def stem_conv_pool(planes: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """planes [B, 3*H, W] (the warp kernel's planar layout), BN-folded conv
    weights [64,3,7,7] and bias [64] in the same dtype (float32 or bfloat16)
    -> pooled stem output [B, H/4, W/4, 64] NHWC in that dtype."""
    if planes.device.type == "cpu":
        return stem_conv_pool_reference(planes, weight, bias)
    if planes.device.type != "cuda":
        raise ValueError(f"no stem kernel for device {planes.device}")
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        out = _run(_launcher(), stream, planes, weight, bias)
    stem_conv_pool.launches += 1
    return out


stem_conv_pool.launches = 0


def _run(launch, stream, planes, weight, bias):
    """The CUDA branch with its launcher and stream given: validate,
    allocate the output on the planes' device and launch.  The CPU tests
    pass a host build of the source here."""
    _check(planes, weight, bias)
    b, ch, w = planes.shape
    h = ch // 3
    out = torch.empty((b, h // 4, w // 4, OUT_CHANNELS), dtype=planes.dtype,
                      device=planes.device)
    err = launch(planes.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), b, h, w, int(planes.dtype == torch.bfloat16),
                 stream)
    if err != 0:
        raise RuntimeError(f"stem kernel launch failed with CUDA error {err}")
    return out
