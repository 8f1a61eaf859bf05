"""The reference's augmentation and eval preprocessing, in plain PyTorch.

Frozen copies of the function the program's warp kernel (B1) computes and
of its draws: per-sample parameters drawn uniform in their limits, each
gated by a Bernoulli(p), from a torch.Generator in a fixed order (nine
draws of the global batch's rows a step); shift-scale-rotate then flip as
one dst->src affine; the two-pass (Catmull-Smith) warp with reflect-101
borders and clipped per-line shifts; brightness/contrast, clip to 0..255
and ImageNet normalization on the 0..255 scale; a segmentation mask as a
4th plane (mean 0, std 1) thresholded at 127.5*alpha + 255*beta.  The eval
form (B2) is (x - 255*mean)/(255*std).  All in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# the augmentation's limits and probabilities (Albumentations' chain of the
# reference project: ShiftScaleRotate 0.05/0.05/15 deg p 0.7, HorizontalFlip
# p 0.5, RandomBrightnessContrast 0.1/0.1 p 0.5)
SHIFT, SCALE, ROTATE, AFFINE_P = 0.05, 0.05, 15.0, 0.7
HFLIP_P, BRIGHT, CONTRAST, BC_P = 0.5, 0.1, 0.1, 0.5
PAD, MAX_SHIFT = 80, 64  # the two-pass warp's padded canvas and shift bound


class Draw(NamedTuple):
    angle: torch.Tensor
    scale: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    flip: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor


def draw(gen: torch.Generator, rows: int) -> Draw:
    """One step's parameters for a global batch of `rows`."""
    def uniform(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(rows, generator=gen, device=gen.device)

    affine = uniform() < AFFINE_P
    angle = torch.where(affine, uniform(-ROTATE, ROTATE), 0.0)
    scale = torch.where(affine, 1.0 + uniform(-SCALE, SCALE), 1.0)
    dx = torch.where(affine, uniform(-SHIFT, SHIFT), 0.0)
    dy = torch.where(affine, uniform(-SHIFT, SHIFT), 0.0)
    flip = uniform() < HFLIP_P
    bc = uniform() < BC_P
    alpha = torch.where(bc, 1.0 + uniform(-CONTRAST, CONTRAST), 1.0)
    beta = torch.where(bc, uniform(-BRIGHT, BRIGHT), 0.0)
    return Draw(angle, scale, dx, dy, flip, alpha, beta)


def matrices(d: Draw, h: int, w: int) -> torch.Tensor:
    """dst->src [B, 2, 3]: the inverse of rotate-scale about the centre and
    shift, composed with the flip's (applied after it)."""
    ang = torch.deg2rad(d.angle)
    cos, sin = torch.cos(ang) * d.scale, torch.sin(ang) * d.scale
    cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
    tx, ty = d.dx * w, d.dy * h
    det = cos * cos + sin * sin
    i00, i01, i10, i11 = cos / det, sin / det, -sin / det, cos / det
    ox = cx - i00 * (cx + tx) - i01 * (cy + ty)
    oy = cy - i10 * (cx + tx) - i11 * (cy + ty)
    ssr = torch.stack([torch.stack([i00, i01, ox], -1), torch.stack([i10, i11, oy], -1)], -2)
    b = d.flip.shape[0]
    flip = torch.eye(2, 3, device=ssr.device).expand(b, 2, 3).clone()
    flip[:, 0, 0] = torch.where(d.flip, -1.0, 1.0)
    flip[:, 0, 2] = torch.where(d.flip, w - 1.0, 0.0)
    lin = torch.matmul(ssr[..., :2], flip[..., :2])
    off = torch.matmul(ssr[..., :2], flip[..., 2:]) + ssr[..., 2:]
    return torch.cat([lin, off], -1)


def _reflect(j: torch.Tensor, n: int) -> torch.Tensor:
    period = 2 * (n - 1)
    r = torch.remainder(j.abs(), period)
    return torch.minimum(r, period - r)


def _shift(delta: torch.Tensor):
    delta = delta.clamp(-(MAX_SHIFT - 1.0), MAX_SHIFT - 1.0)
    k = torch.floor(delta)
    return k, delta - k


def _taps(src: torch.Tensor):
    j0 = torch.floor(src)
    return [(j0, 1.0 - (src - j0)), (j0 + 1.0, 1.0 - ((j0 + 1.0) - src))]


def warp(images: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Two-pass bilinear warp of [B,H,W,C] images by dst->src `mats`:
    float32 [B,H,W,C] on the 0..255 scale."""
    b, h, w, c = images.shape
    dev = images.device
    hp, wp = h + 2 * PAD, w + 2 * PAD
    mid_row, mid_col = (hp - 1) * 0.5, (wp - 1) * 0.5
    m = mats.to(torch.float32)
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m02p = m02 + PAD * (1.0 - m00 - m01)
    m12p = m12 + PAD * (1.0 - m10 - m11)
    bb = m01 / m11
    aa = m00 - bb * m10
    cc = m02p - bb * m12p
    aa, cc, bb, m11, m12p, m10 = (s[:, None, None] for s in (aa, cc, bb, m11, m12p, m10))
    off_a, off_b = cc + bb * mid_row, m12p + m10 * mid_col
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None] + PAD
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :] + PAD
    flat = images.reshape(b, h * w, c)

    def gather(row, col):
        idx = (row * w + col).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c).to(torch.float32)

    def pass_a(j):
        ka, fa = _shift(bb * (j - mid_row) / aa)
        row = _reflect(j.long() - PAD, h)
        shifted = []
        for s in (0, 1):
            src = aa * (xs + ka + s) + off_a
            acc = None
            for jj, wgt in _taps(src):
                term = wgt[..., None] * gather(row, _reflect(jj.long() - PAD, w))
                acc = term if acc is None else acc + term
            shifted.append(acc)
        return shifted[0] * (1 - fa)[..., None] + shifted[1] * fa[..., None]

    kb, fb = _shift(m10 * (xs - mid_col) / m11)
    rows = []
    for t in (0, 1):
        src = m11 * (ys + kb + t) + off_b
        acc = None
        for jj, wgt in _taps(src):
            valid = (jj >= 0) & (jj <= hp - 1)
            term = torch.where(valid, wgt, 0.0)[..., None] * pass_a(jj.clamp(0, hp - 1))
            acc = term if acc is None else acc + term
        rows.append(acc)
    return rows[0] * (1 - fb)[..., None] + rows[1] * fb[..., None]


def augment(images: torch.Tensor, d: Draw, masks: Optional[torch.Tensor] = None):
    """(normalized float32 images [B,H,W,3], masks [B,H,W,1] in {0,1} or None)."""
    b, h, w, _ = images.shape
    x = images if masks is None else torch.cat([images, masks[..., None]], -1)
    out = warp(x, matrices(d, h, w))
    a, bt = d.alpha[:, None, None, None], d.beta[:, None, None, None]
    out = (out * a + bt * 255.0).clamp(0.0, 255.0)
    extra = out.shape[-1] - 3  # the mask's plane: mean 0, std 1
    mean = torch.tensor([m * 255.0 for m in MEAN] + [0.0] * extra, device=out.device)
    std = torch.tensor([s * 255.0 for s in STD] + [1.0] * extra, device=out.device)
    out = (out - mean) / std
    m = None
    if masks is not None:
        thr = (127.5 * d.alpha + d.beta * 255.0)[:, None, None]
        m = (out[..., 3] > thr).to(torch.float32)[..., None]
    return out[..., :3], m


def eval_preprocess(images: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, dtype=torch.float32, device=images.device) * 255.0
    std = torch.tensor(STD, dtype=torch.float32, device=images.device) * 255.0
    return (images.to(torch.float32) - mean) / std


def dropout_keep(gen: torch.Generator, rows: int, features: int, p: float) -> torch.Tensor:
    """The head's dropout draw for a global batch: keep where u < 1 - p."""
    return torch.rand((rows, features), generator=gen, device=gen.device) < 1.0 - p


def batch_rows(order: Sequence[int], batch: int):
    """Consecutive batches of `order`, each sorted (the loader's reads)."""
    import numpy as np

    order = np.asarray(order)
    return [np.sort(order[s:s + batch]) for s in range(0, len(order), batch)]
