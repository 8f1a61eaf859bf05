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
the two devices.  preprocess_eval_batch makes the same split: on the card
it is one launch of the photometric kernel's eval form (no alpha, beta or
flip), one device operation, which computes the CPU branch's
normalization bit for bit.

s2d=True (classification only; masks ignore it, as in the JAX package)
emits the images in the stem's space-to-depth layout [B,H/2,W/2,12]
(ops/image.py space_to_depth, models/resnet.py FoldedStem).  On the card
the warp kernel writes its planar form [B,3H,W] and one permute makes
the s2d layout, in place of the planar-to-NHWC step; the eval form is
the photometric kernel's output shuffled.  On the CPU the plain
versions' NHWC output is shuffled.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from medseg_tpu_torch.core.config import AugmentConfig
from medseg_tpu_torch.ops import image as I
from medseg_tpu_torch.ops.kernels.photometric import fused_photometric
from medseg_tpu_torch.ops.kernels.warp_kernel import warp_affine_kernel
from medseg_tpu_torch.ops.warp_fast import (fast_warp_supports,
                                            photometric_threshold_ok)
from medseg_tpu_torch.parallel.sharding import global_rows, local_rows


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
    """Draw one batch of parameters on `gen`'s device.  Under data
    parallelism each draw is made for the global batch and this rank keeps
    its `batch` rows, so W ranks draw what one process draws."""
    rows = global_rows(batch)

    def uniform(lo=0.0, hi=1.0):
        u = local_rows(torch.rand(rows, generator=gen, device=gen.device))
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


def envelope_edge_matrices(h: int, w: int, device=None) -> torch.Tensor:
    """Four dst->src matrices at the edge of the default envelope: the
    largest rotation (+-15 deg) and shift (5%) both ways, scale 0.9 and 1.1
    (twice the scale limit), with and without the flip.  The warp kernel is
    held to its plain version on these."""
    cfg = AugmentConfig()
    sign = torch.tensor([1.0, -1.0, -1.0, 1.0], device=device)
    params = AugmentParams(
        angle_deg=torch.tensor([1.0, -1.0, 1.0, -1.0], device=device) * cfg.rotate_limit_deg,
        scale=torch.tensor([0.9, 1.1, 1.1, 0.9], device=device),
        dx=sign * cfg.shift_limit, dy=-sign * cfg.shift_limit,
        flip=torch.tensor([False, True, False, True], device=device),
        alpha=torch.ones(4, device=device), beta=torch.zeros(4, device=device))
    return _combined_matrices(params, h, w)


def _on_card(images: torch.Tensor) -> bool:
    """Whether augment_batch and preprocess_eval_batch take the kernel
    branch (the device split above); a test may force the branch onto CPU
    tensors, where the kernel wrappers compute it with their plain
    versions."""
    return images.is_cuda


def augment_batch(
    gen: torch.Generator,
    images: torch.Tensor,
    masks: Optional[torch.Tensor] = None,
    *,
    cfg: AugmentConfig = AugmentConfig(),
    out_dtype=torch.float32,
    fast_warp: bool = True,
    s2d: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full train-time augmentation for a uint8 NHWC batch.

    images: uint8 [B,H,W,3]; masks: uint8 [B,H,W] binary 0/255, or None.
    Returns (normalized images [B,H,W,3] in out_dtype, or [B,H/2,W/2,12]
    with s2d and no masks; masks [B,H,W,1] in [0,1] or None).
    fast_warp=False, or a config outside the two-pass warp's envelope,
    takes the exact single-pass warp.
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
        planar = s2d and masks is None
        out = warp_affine_kernel(inp, mats, out_dtype=k_dtype,
                                 alpha=params.alpha, beta=params.beta,
                                 mean=mean, std=std, planar=planar)
        if planar:  # [B, 3H, W] -> [B, H/2, W/2, 12] in one permute
            x = out.reshape(b, 3, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
            return x.reshape(b, h // 2, w // 2, 12), None
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
    if s2d and masks is None:
        x = I.space_to_depth(x)

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
    s2d: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Val/test preprocessing: normalize only (reference utils/trainer.py:71-83);
    s2d as in augment_batch."""
    if _on_card(images):
        x = fused_photometric(images, None, None, None, out_dtype, cfg.mean, cfg.std)
    else:
        x = I.normalize_imagenet(images, cfg.mean, cfg.std).to(out_dtype)
    if s2d and masks is None:
        x = I.space_to_depth(x)
    m = None
    if masks is not None:
        m = (masks[..., None].to(torch.float32) / 255.0).to(out_dtype)
    return x, m
