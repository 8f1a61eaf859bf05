"""Affine builders, the exact reflect-101 warp and ImageNet normalization.

Counterpart of medseg_tpu/ops/image.py:117-234, NHWC, batched over the
leading dim.  Matrices are dst->src 2x3 affines in unpadded pixel
coordinates; every builder computes in float32 in the same operation order
as the JAX package.
"""

from __future__ import annotations

from typing import Sequence

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
    dev = images.device
    mean = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    std = torch.tensor(std, dtype=torch.float32, device=dev) * 255.0
    return (images.to(torch.float32) - mean) / std
