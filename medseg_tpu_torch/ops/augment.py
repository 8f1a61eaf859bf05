"""The fused train-time augmentation chain for uint8 NHWC batches.

Counterpart of medseg_tpu/ops/augment.py: parameter sampling, one affine
warp (shift-scale-rotate and horizontal flip folded into one matrix),
brightness/contrast, then ImageNet normalization.  Each parameter is uniform
in its limit range and gated by an independent Bernoulli(p) per sample, as
in Albumentations.  Draws come from a torch.Generator, so they are not
JAX's numbers; tests inject one draw into both packages instead.

Device split, as in the JAX package (its TPU/CPU split): for CUDA tensors
augment_batch makes one call of the warp kernel with the photometric
epilogue fused, and a segmentation mask rides as a 4th plane (mean 0,
std 1) that is warped bilinearly and thresholded at 127.5*alpha + 255*beta.
For CPU tensors it warps with the kernel's plain version, applies
brightness/contrast and normalization as separate steps, and warps masks
with true nearest sampling, so masks can differ on region edges between
the two devices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from medseg_tpu_torch.core.config import AugmentConfig
from medseg_tpu_torch.ops import image as I
from medseg_tpu_torch.ops.kernels.warp_kernel import warp_affine_kernel
from medseg_tpu_torch.ops.warp_fast import (fast_warp_supports,
                                            photometric_threshold_ok)


class AugmentParams(NamedTuple):
    """Per-sample augmentation draw; every field has shape (B,)."""

    angle_deg: torch.Tensor
    scale: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    flip: torch.Tensor  # bool
    alpha: torch.Tensor  # contrast multiplier
    beta: torch.Tensor  # brightness offset, fraction of 255


def sample_augment_params(gen: torch.Generator, batch: int,
                          cfg: AugmentConfig) -> AugmentParams:
    """Draw one batch of parameters on `gen`'s device."""

    def uniform(lo=0.0, hi=1.0):
        u = torch.rand(batch, generator=gen, device=gen.device)
        return lo + (hi - lo) * u

    apply_affine = uniform() < cfg.affine_p
    angle = uniform(-cfg.rotate_limit_deg, cfg.rotate_limit_deg)
    scale = 1.0 + uniform(-cfg.scale_limit, cfg.scale_limit)
    dx = uniform(-cfg.shift_limit, cfg.shift_limit)
    dy = uniform(-cfg.shift_limit, cfg.shift_limit)
    angle = torch.where(apply_affine, angle, 0.0)
    scale = torch.where(apply_affine, scale, 1.0)
    dx = torch.where(apply_affine, dx, 0.0)
    dy = torch.where(apply_affine, dy, 0.0)

    flip = uniform() < cfg.hflip_p

    apply_bc = uniform() < cfg.brightness_contrast_p
    alpha = 1.0 + uniform(-cfg.contrast_limit, cfg.contrast_limit)
    beta = uniform(-cfg.brightness_limit, cfg.brightness_limit)
    alpha = torch.where(apply_bc, alpha, 1.0)
    beta = torch.where(apply_bc, beta, 0.0)
    return AugmentParams(angle, scale, dx, dy, flip, alpha, beta)


def _combined_matrices(params: AugmentParams, h: int, w: int) -> torch.Tensor:
    """One dst->src matrix per sample: flip applied after shift-scale-rotate.

    Reference order is SSR then HorizontalFlip (utils/trainer.py:61-64); in
    inverse (dst->src) composition that is ssr_inv ∘ flip_inv.
    """
    ssr = I.shift_scale_rotate_matrix(params.angle_deg, params.scale,
                                      params.dx, params.dy, h, w)
    dev = ssr.device
    flip = I.hflip_matrix(w, device=dev).expand_as(ssr)
    ident = I.identity_affine((params.flip.shape[0],), device=dev)
    flip = torch.where(params.flip[:, None, None], flip, ident)
    return I.compose_affine(ssr, flip)


def _on_card(images: torch.Tensor) -> bool:
    """Whether augment_batch takes the fused-kernel branch (the device split
    above); a test may force the branch onto CPU tensors, where the kernel
    wrapper computes it with the plain version."""
    return images.is_cuda


def augment_batch(
    gen: torch.Generator,
    images: torch.Tensor,
    masks: Optional[torch.Tensor] = None,
    *,
    cfg: AugmentConfig = AugmentConfig(),
    out_dtype=torch.float32,
    fast_warp: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full train-time augmentation for a uint8 NHWC batch.

    images: uint8 [B,H,W,3]; masks: uint8 [B,H,W] binary 0/255, or None.
    Returns (normalized images [B,H,W,3] in out_dtype, masks [B,H,W,1] in
    [0,1] or None).  fast_warp=False, or a config outside the two-pass
    warp's envelope, takes the exact single-pass warp.
    """
    b, h, w, _ = images.shape
    params = sample_augment_params(gen, b, cfg)
    params = AugmentParams(*(p.to(images.device) for p in params))
    mats = _combined_matrices(params, h, w)

    fast_warp = fast_warp and fast_warp_supports(cfg, h, w)
    fused = _on_card(images) and (masks is None or photometric_threshold_ok(cfg))
    if fast_warp and fused:
        mean = tuple(m * 255.0 for m in cfg.mean)
        std = tuple(s * 255.0 for s in cfg.std)
        inp = images
        if masks is not None:
            inp = torch.cat([images, masks[..., None]], dim=-1)
            mean = mean + (0.0,)
            std = std + (1.0,)
        # Classification writes the model's dtype directly; segmentation
        # keeps float32, since the mask plane is thresholded on the way out.
        k_dtype = out_dtype if masks is None else torch.float32
        out = warp_affine_kernel(inp, mats, out_dtype=k_dtype,
                                 alpha=params.alpha, beta=params.beta,
                                 mean=mean, std=std)
        x = out[..., :3].to(out_dtype)
        m = None
        if masks is not None:
            thr = (127.5 * params.alpha + params.beta * 255.0)[:, None, None]
            m = (out[..., 3] > thr).to(out_dtype)[..., None]
        return x, m

    if fast_warp:
        x = warp_affine_kernel(images, mats)
    else:
        x = I.warp_affine(images, mats, bilinear=True)
    # RandomBrightnessContrast on 0..255 values (brightness_by_max=True).
    x = x * params.alpha[:, None, None, None] \
        + params.beta[:, None, None, None] * 255.0
    x = torch.clamp(x, 0.0, 255.0)
    x = I.normalize_imagenet(x, cfg.mean, cfg.std).to(out_dtype)

    m = None
    if masks is not None:
        if fast_warp:
            m = warp_affine_kernel(masks[..., None], mats, nearest=True)
        else:
            m = I.warp_affine(masks[..., None], mats, bilinear=False)
        m = (m.to(torch.float32) / 255.0).to(out_dtype)
    return x, m


def preprocess_eval_batch(
    images: torch.Tensor,
    masks: Optional[torch.Tensor] = None,
    *,
    cfg: AugmentConfig = AugmentConfig(),
    out_dtype=torch.float32,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Val/test preprocessing: normalize only (reference utils/trainer.py:71-83)."""
    x = I.normalize_imagenet(images, cfg.mean, cfg.std).to(out_dtype)
    m = None
    if masks is not None:
        m = (masks[..., None].to(torch.float32) / 255.0).to(out_dtype)
    return x, m
