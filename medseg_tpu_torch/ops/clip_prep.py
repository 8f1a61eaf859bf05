"""CLIP-family preprocessing on the device.

Counterpart of medseg_tpu/ops/clip_prep.py:19-32: uint8 NHWC images ->
CLIP-normalized float NHWC at (size, size).

- A batch at another size (the eval harness's packed 256 batches) is
  resized to float32 by jax.image.resize's bicubic (ops/image.resize_jax),
  clipped to [0, 255] and normalized with CLIP's mean and std: plain torch
  operations, as the JAX package leaves them to XLA.
- A batch already at `size` (the serving path: each original was resized to
  the model's uint8 grid first, infer/pipeline.py) is B2's eval form with
  CLIP's constants, (x - 255*mean_c)/(255*std_c): one launch of the
  photometric kernel for a CUDA tensor, its plain version for a CPU tensor
  (ops/kernels/photometric.py).  There is no fallback from the kernel.
"""

from __future__ import annotations

import torch

from medseg_tpu_torch.core.config import CLIP_MEAN, CLIP_STD
from medseg_tpu_torch.ops import image as I
from medseg_tpu_torch.ops.kernels.photometric import fused_photometric


def clip_preprocess(images_u8: torch.Tensor, size: int,
                    out_dtype=torch.float32) -> torch.Tensor:
    """uint8 [B,H,W,3] -> CLIP-normalized [B,size,size,3] in out_dtype."""
    if images_u8.shape[1:3] == (size, size):
        return fused_photometric(images_u8, None, None, None, out_dtype,
                                 CLIP_MEAN, CLIP_STD)
    x = I.resize_jax(images_u8, size, size, "bicubic").clamp_(0.0, 255.0)
    return I.normalize_imagenet(x, CLIP_MEAN, CLIP_STD).to(out_dtype)
