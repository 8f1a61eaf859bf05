"""Host-side overlay rendering (reference utils/pipeline.py:398-411 semantics).

The port's copy of medseg_tpu/infer/overlay.py.  The mask is
nearest-resized to the original image size and blended as pure red at the
given opacity: blended = original*1.0 + red_overlay*opacity
(cv2.addWeighted semantics, saturating uint8).
"""

from __future__ import annotations

import numpy as np


def resize_mask_nearest(mask: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.INTER_NEAREST-convention index mapping (floor(dst*scale))."""
    h, w = mask.shape[:2]
    if (h, w) == (out_h, out_w):
        return mask
    iy = np.clip(np.floor(np.arange(out_h) * (h / out_h)).astype(np.int64), 0, h - 1)
    ix = np.clip(np.floor(np.arange(out_w) * (w / out_w)).astype(np.int64), 0, w - 1)
    return mask[iy][:, ix]


def red_overlay(image_rgb: np.ndarray, mask: np.ndarray,
                opacity: float = 0.5) -> np.ndarray:
    """image uint8 [H,W,3] RGB, mask uint8 {0,255} any size -> blended RGB."""
    h, w = image_rgb.shape[:2]
    mask_r = resize_mask_nearest(mask, h, w)
    overlay = np.zeros_like(image_rgb)
    overlay[mask_r == 255] = (255, 0, 0)
    blended = image_rgb.astype(np.float32) + overlay.astype(np.float32) * opacity
    return np.clip(np.round(blended), 0, 255).astype(np.uint8)
