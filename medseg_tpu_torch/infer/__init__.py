from medseg_tpu_torch.infer.overlay import red_overlay, resize_mask_nearest  # noqa: F401
from medseg_tpu_torch.infer.pipeline import Pipeline  # noqa: F401
