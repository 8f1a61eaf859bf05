"""Affine builders, the exact reflect-101 warp, ImageNet normalization and
the bilinear resize.

Counterpart of medseg_tpu/ops/image.py:31-71 and 117-234, NHWC, batched
over the leading dim.  Matrices are dst->src 2x3 affines in unpadded pixel
coordinates; every builder computes in float32 in the same operation order
as the JAX package.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


def _reflect101(coord: torch.Tensor, n: int) -> torch.Tensor:
    """Fold float coordinates into [0, n-1] with reflect-101 (no edge repeat)."""
    if n == 1:
        return torch.zeros_like(coord)
    period = 2.0 * (n - 1)
    c = torch.remainder(coord.abs(), period)
    return torch.where(c > n - 1, period - c, c)


def _gather_hw(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img [B,H,W,C], integer index maps yi/xi [B,h,w] -> [B,h,w,C]."""
    b, h, w, c = img.shape
    idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
    out = torch.gather(img.reshape(b, h * w, c), 1, idx)
    return out.reshape(*yi.shape, c)


def warp_affine(images: torch.Tensor, matrices: torch.Tensor, *,
                bilinear: bool = True) -> torch.Tensor:
    """Exact single-pass affine warp with reflect-101 borders.

    images [B,H,W,C] (any real dtype), matrices [B,2,3] dst->src.  Bilinear
    returns float32; nearest keeps the input dtype.  This is the path
    augment_batch takes outside the fast warp's envelope.
    """
    b, h, w, _ = images.shape
    dev = images.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    m = matrices.to(torch.float32)[:, :, :, None, None]
    src_x = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    src_y = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    src_x = _reflect101(src_x, w)
    src_y = _reflect101(src_y, h)
    if bilinear:
        x0 = torch.floor(src_x)
        y0 = torch.floor(src_y)
        wx = (src_x - x0)[..., None]
        wy = (src_y - y0)[..., None]
        x0i = x0.long().clamp(0, w - 1)
        y0i = y0.long().clamp(0, h - 1)
        x1i = (x0i + 1).clamp(0, w - 1)
        y1i = (y0i + 1).clamp(0, h - 1)
        f = images.to(torch.float32)
        v00 = _gather_hw(f, y0i, x0i)
        v01 = _gather_hw(f, y0i, x1i)
        v10 = _gather_hw(f, y1i, x0i)
        v11 = _gather_hw(f, y1i, x1i)
        return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
                + v10 * (1 - wx) * wy + v11 * wx * wy)
    yi = torch.round(src_y).long().clamp(0, h - 1)
    xi = torch.round(src_x).long().clamp(0, w - 1)
    return _gather_hw(images, yi, xi)


def shift_scale_rotate_matrix(angle_deg, scale, dx, dy, h: int, w: int) -> torch.Tensor:
    """Inverse (dst->src) matrix for ShiftScaleRotate about the image center.

    Forward transform (Albumentations, reference utils/trainer.py:61-63):
    rotate by `angle_deg` and scale about the center, then translate by
    (dx*w, dy*h).  Batched over the leading dims of the float32 inputs.
    """
    angle = torch.deg2rad(angle_deg)
    cos = torch.cos(angle) * scale
    sin = torch.sin(angle) * scale
    cx = (w - 1) * 0.5
    cy = (h - 1) * 0.5
    tx = dx * w
    ty = dy * h
    # Forward: dst = R @ (src - c) + c + t  =>  src = R^-1 @ (dst - c - t) + c
    det = cos * cos + sin * sin
    inv00 = cos / det
    inv01 = sin / det
    inv10 = -sin / det
    inv11 = cos / det
    ox = cx - inv00 * (cx + tx) - inv01 * (cy + ty)
    oy = cy - inv10 * (cx + tx) - inv11 * (cy + ty)
    row0 = torch.stack([inv00, inv01, ox], dim=-1)
    row1 = torch.stack([inv10, inv11, oy], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def hflip_matrix(w: int, device=None) -> torch.Tensor:
    """dst->src matrix for a horizontal flip.  Built on the device by fill
    kernels: a host tensor copied to the card (torch.tensor(..., device=),
    or `m[0, 0] = -1.0`, which copies a host scalar) would synchronize the
    train step."""
    m = torch.eye(2, 3, dtype=torch.float32, device=device)
    m[0, 0].fill_(-1.0)
    m[0, 2].fill_(w - 1.0)
    return m


def compose_affine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose two dst->src 2x3 affines: src = a @ (b @ dst), i.e. `a ∘ b`."""
    a2 = a[..., :, :2]
    lin = torch.matmul(a2, b[..., :, :2])
    off = torch.matmul(a2, b[..., :, 2:]) + a[..., :, 2:]
    return torch.cat([lin, off], dim=-1)


def identity_affine(batch_shape=(), device=None) -> torch.Tensor:
    eye = torch.eye(2, 3, dtype=torch.float32, device=device)
    return eye.expand(*batch_shape, 2, 3)


def normalize_imagenet(images: torch.Tensor, mean: Sequence[float],
                       std: Sequence[float]) -> torch.Tensor:
    """uint8/float [B,H,W,3] in [0,255] -> float32 normalized (A.Normalize)."""
    mean, std = _scaled_constants(tuple(mean), tuple(std), images.device)
    return (images.to(torch.float32) - mean) / std


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B,H,W,C] -> [B,H/2,W/2,4C], channel order c*4 + dy*2 + dx
    (medseg_tpu/ops/image.py:237-246): the stem's input layout
    (models/resnet.py FoldedStem).  NCHW's F.pixel_unshuffle order; the
    U-Net twins' order (nn/s2d.py) is another."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, c * 4)


@functools.lru_cache(maxsize=16)
def _scaled_constants(mean: tuple, std: tuple, device: torch.device):
    """(255*mean, 255*std) in float32 on `device`, copied there once per
    device: a copy from the host each call synchronized the finetune step."""
    return tuple(host_to_device((torch.tensor(v, dtype=torch.float32) * 255.0).numpy(), device)
                 for v in (mean, std))


# --------------------------------------------------------------------------
# Resize (medseg_tpu/ops/image.py:31-71)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _linear_resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation matrix, half-pixel convention
    (src = (dst + 0.5) * n_in / n_out - 0.5, edges clamped), as cv2 and
    Albumentations resize."""
    scale = n_in / n_out
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    x0 = np.floor(src).astype(np.int64)
    w1 = src - x0
    x1 = np.clip(x0 + 1, 0, n_in - 1)
    x0 = np.clip(x0, 0, n_in - 1)
    mat = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)
    np.add.at(mat, (rows, x0), (1.0 - w1).astype(np.float32))
    np.add.at(mat, (rows, x1), w1.astype(np.float32))
    return mat


@functools.lru_cache(maxsize=64)
def _jax_resize_matrix(n_out: int, n_in: int, method: str) -> np.ndarray:
    """[n_out, n_in] float32 matrix of jax.image.resize along one axis
    (jax._src.image.scale.compute_weight_mat, antialias on, no translation),
    in its float32 operations: sample positions on the half-pixel
    convention, the Keys cubic (a = -0.5) or triangle kernel widened by
    n_in/n_out when downsampling, each output's weights divided by their sum
    over the input, and zero for a sample outside the input.

    A weight moves by up to 1.5x its sample position's error, and one
    float32 ulp at position 128 is 7.6e-6; XLA's CPU code fuses the
    position's multiply-add into one rounding, so it is computed here in
    float64 and rounded once (rounding twice, the weights of 384 -> 224
    land 7.2e-6 from JAX's; once, within 7.1e-7 for every shape tested)."""
    kernel = {"bicubic": _keys_cubic, "bilinear": _triangle}[method]
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))  # a Python double in JAX, then float32
    kernel_scale = max(inv_scale, f32(1.0))
    half_pixel = np.arange(n_out, dtype=np.float64) + 0.5
    sample = (half_pixel * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    weights = kernel(x)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).T.astype(f32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)


def _resize_matrix(n_out: int, n_in: int, method: str) -> np.ndarray:
    """The interpolation matrix of `method`: "linear" is the cv2-style
    bilinear of resize_bilinear, "bicubic" and "bilinear" jax.image.resize's."""
    if method == "linear":
        return _linear_resize_matrix(n_out, n_in)
    return _jax_resize_matrix(n_out, n_in, method)


@functools.lru_cache(maxsize=64)
def _resize_taps(n_out: int, n_in: int, method: str, device: torch.device):
    """The matrix's non-zeros on `device`, as K taps: for each output row,
    the columns from its first to its last non-zero ([K, n_out] indices)
    and their weights ([K, n_out]; 0 past a row's last non-zero, whose
    index then repeats it).  Built once per shape, method and device."""
    mat = _resize_matrix(n_out, n_in, method)
    nz = mat != 0
    first = nz.argmax(axis=1)
    last = n_in - 1 - nz[:, ::-1].argmax(axis=1)
    k = int((last - first).max()) + 1
    idx = np.minimum(first[None, :] + np.arange(k)[:, None], last[None, :])
    weights = np.where(first[None, :] + np.arange(k)[:, None] <= last[None, :],
                       mat[np.arange(n_out)[None, :], idx], np.float32(0.0))
    return host_to_device(idx, device), host_to_device(weights, device)


def host_to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device` (copied first where it is not
    C-contiguous or not writable, as PIL's arrays are).  To the card it
    goes from pinned memory without blocking, so the host does not wait
    for the card's queue (a copy from pageable memory synchronizes the
    stream)."""
    t = torch.from_numpy(np.require(array, requirements=["C", "W"]))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _contract(x: torch.Tensor, dim: int, n_out: int, method: str) -> torch.Tensor:
    """x (float32) contracted with the interpolation matrix along `dim`: the
    taps' products summed in column order."""
    idx, weights = _resize_taps(n_out, x.shape[dim], method, x.device)
    shape = [1] * x.dim()
    shape[dim] = n_out
    out = x.index_select(dim, idx[0]) * weights[0].view(shape)
    for k in range(1, idx.shape[0]):
        out = out + x.index_select(dim, idx[k]) * weights[k].view(shape)
    return out


def _resize(images: torch.Tensor, out_h: int, out_w: int, method: str) -> torch.Tensor:
    """NHWC (or NHW) of any real dtype -> float32, rows then columns; a
    dimension already at its size is left as it is."""
    squeeze = images.dim() == 3
    if squeeze:
        images = images[..., None]
    _, h, w, _ = images.shape
    x = images.to(torch.float32)
    if h != out_h:
        x = _contract(x, 1, out_h, method)
    if w != out_w:
        x = _contract(x, 2, out_w, method)
    return x[..., 0] if squeeze else x


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Batched bilinear resize, NHWC (or NHW) of any real dtype -> float32:
    the two contractions of medseg_tpu's resize_bilinear, rows then
    columns, with the same half-pixel matrices.

    Each contraction is computed over the two non-zeros of each matrix row
    (a gather, two float32 multiplies and an add) rather than by a GEMM.
    Under torch.backends.cuda.matmul.allow_tf32 (or a float32 matmul
    precision below "highest") a GEMM on the card would round its operands
    to TF32's 10-bit mantissa and move the rounding of many pixels of a
    uint8 resize; elementwise float32 operations never take TF32, so this
    function computes the same float32 values whatever those flags say.
    Against the JAX package's matmul the sums may round differently in the
    last bit (the zero terms add exactly; the two products may be fused
    there), which moves a value across a rounding tie only rarely."""
    if images.shape[1:3] == (out_h, out_w):
        return images.to(torch.float32)
    return _resize(images, out_h, out_w, "linear")


def resize_jax(images: torch.Tensor, out_h: int, out_w: int,
               method: str = "bicubic") -> torch.Tensor:
    """jax.image.resize of an NHWC (or NHW) batch over H and W, any real
    dtype -> float32: `method` "bicubic" (Keys, a = -0.5) or "bilinear",
    with JAX's antialiasing when downsampling
    (medseg_tpu/ops/clip_prep.py:28, infer/pipeline.py:181,
    eval/harness.py:178).  F.interpolate computes other weights (up to 0.77
    apart at 1024 -> 224, and within 7.3e-6 with antialias=True).  The
    contraction is resize_bilinear's: each row's taps (3-5 for bicubic 256
    -> 224, at most 4 upsampling, up to 19 for 1024 -> 224) gathered and
    summed in float32, which no TF32 flag moves; JAX's dense einsum may
    round the same sum differently in the last bit."""
    return _resize(images, out_h, out_w, method)
