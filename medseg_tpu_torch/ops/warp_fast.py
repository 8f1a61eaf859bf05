"""The two-pass affine warp: envelope checks and the warp kernel's plain version.

Counterpart of medseg_tpu/ops/warp_fast.py and the function its Pallas
kernel computes (ops/pallas/warp_kernel.py, bit-identical to
`warp_affine_fast` on the TPU).  The warp factors the dst->src affine into a
horizontal pass A and a vertical pass B (Catmull-Smith).  Each 1-D resample
`src = alpha*t + offset + slope*cross` is a bilinear hat sample at the
line's mean offset, followed by a per-line residual shift clipped to
+-(MAX_SHIFT-1) and blended by its fraction.  So every output value is an
interpolation of interpolations: it differs from the exact single-pass warp
(ops/image.warp_affine) by sub-level smoothing, and it is the function
augment_batch trains on.

`warp_affine_fast` here is written as gathers (16 source taps per channel
for each output pixel) rather than as the TPU's hat matmuls and rolls; it
is the plain PyTorch version that the CUDA kernel (ops/kernels/warp_kernel)
is held against, and it runs each float operation in the same order as the
kernel.  Borders reflect through a reflect-101 index fold, which also works
where the pad exceeds the image (F.pad(mode="reflect") refuses that).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# Padding that contains the max displacement of the SSR family at 256px:
# |src - dst| <= |R^-1 - I| * sqrt(2)*128 + 0.05*256 ~= 73px.
PAD = 80
# Bound on the residual per-line shift: slope <= tan(15deg) ~= 0.27 over the
# 416px padded canvas's half-extent of 208 -> |shift| <= 62.
MAX_SHIFT = 64


def fast_warp_supports(cfg, h: int, w: int) -> bool:
    """Does the (PAD, MAX_SHIFT) envelope contain every transform this
    AugmentConfig can sample?  Widened configs must take the exact warp, or
    they would silently clip shifts.

    Conservative worst case over the sampled family (rotate <= theta,
    scale in [1-s, 1+s], shift <= f of the image size, optional hflip):
    - corner displacement  r*|R(-theta)/smin - I| + f*n/smin  must fit PAD
    - residual per-line shifts of the two 1-D passes
      (smax*sin(theta), tan(theta)) * (padded extent)/2  must fit MAX_SHIFT
    """
    theta = math.radians(abs(cfg.rotate_limit_deg))
    smin = 1.0 - abs(cfg.scale_limit)
    smax = 1.0 + abs(cfg.scale_limit)
    if smin <= 0.1 or theta >= math.radians(45.0):
        return False
    n = float(max(h, w))
    r = math.hypot(h, w) / 2.0
    disp = r * math.hypot(math.cos(theta) / smin - 1.0,
                          math.sin(theta) / smin) \
        + abs(cfg.shift_limit) * n / smin
    if disp > PAD - 1.0:
        return False
    half_padded = (n + 2 * PAD) / 2.0
    delta_h = smax * math.sin(theta) * half_padded
    delta_v = math.tan(theta) * half_padded
    return max(delta_h, delta_v) <= MAX_SHIFT - 1.0


def photometric_threshold_ok(cfg) -> bool:
    """The fused mask trick binarizes at t = 127.5*alpha + beta*255, which
    assumes t stays strictly inside (0, 255) (the clip's linear region).
    Holds iff contrast_limit + 2*brightness_limit < 1."""
    return (abs(cfg.contrast_limit) + 2.0 * abs(cfg.brightness_limit)) < 1.0


def warp_scalars(matrices: torch.Tensor) -> torch.Tensor:
    """[B,2,3] dst->src matrices -> [B,6] float32 per-image scalars
    (aa, cc, bb, m11, m12p, m10) of the two passes, in padded coordinates:
    pass A samples src_x = aa*u + bb*row + cc, pass B src_y = m11*v +
    m10*col + m12p (medseg_tpu/ops/pallas/warp_kernel.py:226-243)."""
    m = matrices.to(torch.float32)
    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m02p = m02 + PAD * (1.0 - m00 - m01)
    m12p = m12 + PAD * (1.0 - m10 - m11)
    bb = m01 / m11
    aa = m00 - bb * m10
    cc = m02p - bb * m12p
    return torch.stack([aa, cc, bb, m11, m12p, m10], dim=-1)


def _reflect101_int(j: torch.Tensor, n: int) -> torch.Tensor:
    """Fold integer coords into [0, n-1] with reflect-101 (no edge repeat)."""
    period = 2 * (n - 1)
    r = torch.remainder(j.abs(), period)
    return torch.minimum(r, period - r)


def _line_shift(delta: torch.Tensor, nearest: bool):
    """Integer part and fraction of a per-line shift, clipped to the roll
    margin."""
    if nearest:
        delta = torch.floor(delta + 0.5)
    delta = delta.clamp(-(MAX_SHIFT - 1.0), MAX_SHIFT - 1.0)
    k = torch.floor(delta)
    return k, delta - k


def _taps(src: torch.Tensor, nearest: bool):
    """[(coordinate, weight)] of a hat sample at src; weights are written
    exactly as the tent 1 - |src - j| evaluates them.  Nearest: one tap of
    weight None (a plain copy)."""
    if nearest:
        return [(torch.floor(src + 0.5), None)]
    j0 = torch.floor(src)
    return [(j0, 1.0 - (src - j0)), (j0 + 1.0, 1.0 - ((j0 + 1.0) - src))]


def warp_affine_fast(images: torch.Tensor, matrices: torch.Tensor,
                     nearest: bool = False, out_dtype=torch.float32,
                     alpha: Optional[torch.Tensor] = None,
                     beta: Optional[torch.Tensor] = None,
                     mean: Optional[Sequence[float]] = None,
                     std: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Plain PyTorch two-pass warp, with the kernel's optional epilogue.

    images [B,H,W,C] (any real dtype), matrices [B,2,3] dst->src in unpadded
    coordinates.  `nearest=True` samples nearest in both passes (masks stay
    binary).  With alpha/beta [B] and per-channel mean/std on the 0..255
    scale, the epilogue clip(x*alpha + 255*beta, 0, 255), then
    (x - mean_c)/std_c is applied.  Returns [B,H,W,C] in `out_dtype`.
    """
    b, h, w, c = images.shape
    dev = images.device
    hp, wp = h + 2 * PAD, w + 2 * PAD
    mid_row = (hp - 1) * 0.5
    mid_col = (wp - 1) * 0.5
    aa, cc, bb, m11, m12p, m10 = (s[:, None, None]
                                  for s in warp_scalars(matrices).unbind(-1))
    off_a = cc + bb * mid_row
    off_b = m12p + m10 * mid_col
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None] + PAD
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :] + PAD
    flat = images.reshape(b, h * w, c)

    def gather(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        idx = (row * w + col).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c).to(torch.float32)

    def pass_a(j: torch.Tensor) -> torch.Tensor:
        """Pass A's value at padded rows j [B,h,w], padded columns xs."""
        ka, fa = _line_shift(bb * (j - mid_row) / aa, nearest)
        row = _reflect101_int(j.long() - PAD, h)
        shifted = []
        for s in ((0,) if nearest else (0, 1)):
            src = aa * (xs + ka + s) + off_a
            acc = None
            for jj, wgt in _taps(src, nearest):
                v = gather(row, _reflect101_int(jj.long() - PAD, w))
                term = v if wgt is None else wgt[..., None] * v
                acc = term if acc is None else acc + term
            shifted.append(acc)
        if nearest:
            return shifted[0]
        return shifted[0] * (1 - fa)[..., None] + shifted[1] * fa[..., None]

    kb, fb = _line_shift(m10 * (xs - mid_col) / m11, nearest)
    rows = []
    for t in ((0,) if nearest else (0, 1)):
        src = m11 * (ys + kb + t) + off_b
        acc = None
        for jj, wgt in _taps(src, nearest):
            # pass B's taps are not reflected: rows outside the padded canvas
            # weigh 0
            valid = (jj >= 0) & (jj <= hp - 1)
            wv = valid.to(torch.float32) if wgt is None else torch.where(valid, wgt, 0.0)
            term = wv[..., None] * pass_a(jj.clamp(0, hp - 1))
            acc = term if acc is None else acc + term
        rows.append(acc)
    out = rows[0] if nearest else rows[0] * (1 - fb)[..., None] + rows[1] * fb[..., None]

    if mean is not None:
        if alpha is None or beta is None:
            raise ValueError("the epilogue needs alpha and beta")
        a = alpha.to(torch.float32)[:, None, None, None]
        bt = beta.to(torch.float32)[:, None, None, None]
        out = (out * a + bt * 255.0).clamp(0.0, 255.0)
        m = torch.tensor(mean, dtype=torch.float32, device=dev)
        sd = torch.tensor(std, dtype=torch.float32, device=dev)
        out = (out - m) / sd
    return out.to(out_dtype)
