"""CLIP zero-shot classifier (ViT-B/32) under HF's names.

Counterpart of medseg_tpu/models/clip.py:26-89 (reference
models/classification_models/CLIP.py:17-85): the text prompts are encoded
once and L2-normalized (interop/text_features.py); the forward encodes the
image, L2-normalizes it and returns `exp(logit_scale) * img @ text.T` in
float32.

`CLIPModule` is HF's `CLIPModel` (both towers, the projections and
`logit_scale`): an HF state dict, or the reference's CLIP_best_acc.pt,
loads into it with strict=True.  `CLIPClassifier`, registered as "CLIP",
is its image side (`vision_model`, `visual_projection`, `logit_scale`),
which takes the precomputed text features as its second input; its state
dict is the full one without the text tower's keys
(interop/text_features.classifier_state_dict).

`init_weights` initializes a ViT module as flax initializes the JAX
package's: embeddings normal(0.02), Linear and conv kernels lecun-normal
with zero biases, LayerNorm weights 1 and biases 0, logit_scale 2.6592.
"""

from __future__ import annotations

import torch
from torch import nn

from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.registry import register_model
from medseg_tpu_torch.models import resnet
from medseg_tpu_torch.nn.vit import (CLIP_B32_VISION, CLIP_TEXT, TextTower, TowerConfig,
                                     VisionEmbeddings, VisionTower)

LOGIT_SCALE_INIT = 2.6592


class CLIPModule(nn.Module):
    """Two-tower CLIP with projections and logit_scale (HF CLIPModel math)."""

    def __init__(self, vision_cfg: TowerConfig = CLIP_B32_VISION,
                 text_cfg: TowerConfig = CLIP_TEXT, projection_dim: int = 512):
        super().__init__()
        self.vision_model = VisionTower(vision_cfg)
        self.text_model = TextTower(text_cfg)
        self.visual_projection = nn.Linear(vision_cfg.hidden_size, projection_dim, bias=False)
        self.text_projection = nn.Linear(text_cfg.hidden_size, projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(LOGIT_SCALE_INIT))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixels)[0])

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_projection(self.text_model(input_ids))

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        img = self.encode_image(pixels)
        txt = self.encode_text(input_ids)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return self.logit_scale.exp() * img @ txt.T


class CLIPClassifier(nn.Module):
    """Image side of the zero-shot classifier: logits against fixed
    (precomputed, normalized) text features (reference CLIP.py:47-65)."""

    def __init__(self, vision_cfg: TowerConfig = CLIP_B32_VISION,
                 projection_dim: int = 512):
        super().__init__()
        self.vision_model = VisionTower(vision_cfg)
        self.visual_projection = nn.Linear(vision_cfg.hidden_size, projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(LOGIT_SCALE_INIT))

    def forward(self, pixels: torch.Tensor, text_features: torch.Tensor) -> torch.Tensor:
        """pixels: NHWC CLIP-normalized; text_features: [num_classes, dim],
        L2-normalized.  Returns float32 [B, num_classes] (float64 for a
        float64 model)."""
        img = self.visual_projection(self.vision_model(pixels)[0])
        dtype = torch.promote_types(img.dtype, torch.float32)
        img = img.to(dtype)
        img = img / img.norm(dim=-1, keepdim=True)
        return self.logit_scale.to(dtype).exp() * img @ text_features.to(dtype).T


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize a ViT model in place as flax initializes the JAX
    package's, drawing from `generator`: resnet.init_weights for the Linear
    and conv kernels (lecun-normal, biases 0), then embeddings (token,
    position, class) normal(0.02), LayerNorm weights 1 and biases 0, and
    logit_scale 2.6592.  The draws are not JAX's numbers; the distribution
    is."""
    resnet.init_weights(model, generator)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, VisionEmbeddings):
                m.class_embedding.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            if isinstance(getattr(m, "logit_scale", None), nn.Parameter):
                m.logit_scale.fill_(LOGIT_SCALE_INIT)
    return model


@register_model("CLIP", task="classification", needs_text_features=True,
                init_weights=init_weights)
def clip_classifier(num_classes: int = 3, device: DeviceLike = None, **kw) -> CLIPClassifier:
    """Randomly initialized on `device` from its global generator (seed
    it first); on the meta device, not initialized.
    The class count is carried by the text features, as in the JAX
    package."""
    del num_classes
    with torch.device(resolve_device(device)):  # initialized where it lives
        return CLIPClassifier(**kw)
