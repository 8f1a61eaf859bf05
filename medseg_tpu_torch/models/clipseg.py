"""CLIPSeg text-prompted segmentation (CIDAS/clipseg-rd64-refined) under
HF's names.

Counterpart of medseg_tpu/models/clipseg.py:34-141 (reference
models/segmentation_models/CLIPSeg.py:13-103): a CLIP ViT-B/16 backbone run
at 352x352 (its 224-trained positions bicubically interpolated), the
activations after encoder layers 3, 6 and 9 each reduced 768 -> 64; the
deepest is FiLM-conditioned by the text embedding (film_mul, film_add),
three post-norm ReLU layers (width 64, 4 heads, MLP 2048) refine the sum,
and the "refined" head (Conv3x3 + ReLU, ConvT k4/s4 64 -> 32, ReLU, ConvT
k4/s4 32 -> 1) upsamples the patch tokens to [B, 352, 352] float32 logits.

Module names are HF's CLIPSegForImageSegmentation's (`clip.` + CLIPModel's
names, `decoder.{film_mul,film_add,reduces.i,layers.i}`,
`decoder.transposed_convolution.{0,2,4}`), so the reference's
CLIPSeg_best_loss.pt loads with strict=True.  The backbone and the text
encoding run under torch.no_grad, as HF runs them; the backbone stops after
layer max(extract_layers) + 1, the deepest one read (the JAX program's
later layers and post_layernorm are dropped by XLA as unused), which
changes no value.  Inputs are NHWC.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.registry import register_model
from medseg_tpu_torch.models.clip import CLIPModule, init_weights
from medseg_tpu_torch.nn.vit import CLIP_B16_VISION, CLIP_TEXT, EncoderLayer, TowerConfig


class CLIPSegDecoder(nn.Module):
    """Reduce + FiLM + post-norm transformer + transposed-conv upsampling."""

    def __init__(self, hidden: int = 768, projection_dim: int = 512, reduce_dim: int = 64,
                 extract_depth: int = 3, patch_size: int = 16, num_heads: int = 4,
                 intermediate_size: int = 2048, conditional_layer: int = 0):
        super().__init__()
        self.conditional_layer = conditional_layer
        layer_cfg = TowerConfig(hidden_size=reduce_dim, num_layers=extract_depth,
                                num_heads=num_heads, intermediate_size=intermediate_size,
                                hidden_act="relu")
        self.film_mul = nn.Linear(projection_dim, reduce_dim)
        self.film_add = nn.Linear(projection_dim, reduce_dim)
        k = patch_size // 4
        self.transposed_convolution = nn.Sequential(
            nn.Conv2d(reduce_dim, reduce_dim, 3, padding=1), nn.ReLU(),
            nn.ConvTranspose2d(reduce_dim, reduce_dim // 2, k, stride=k), nn.ReLU(),
            nn.ConvTranspose2d(reduce_dim // 2, 1, k, stride=k))
        self.reduces = nn.ModuleList(nn.Linear(hidden, reduce_dim)
                                     for _ in range(extract_depth))
        self.layers = nn.ModuleList(EncoderLayer(layer_cfg, post_norm=True)
                                    for _ in range(extract_depth))

    def forward(self, activations: Sequence[torch.Tensor], cond: torch.Tensor) -> torch.Tensor:
        """activations: shallow-to-deep hidden states [B, 1+S, hidden];
        cond: [B, projection_dim].  Returns float32 [B, H, W] logits (float64
        for a float64 model)."""
        output = None
        for i, act in enumerate(reversed(activations)):  # deepest first, as HF
            red = self.reduces[i](act)
            output = red if output is None else red + output
            if i == self.conditional_layer:
                output = self.film_mul(cond)[:, None] * output + self.film_add(cond)[:, None]
            output = self.layers[i](output)
        tokens = output[:, 1:]  # drop CLS
        b, s, c = tokens.shape
        size = int(round(s ** 0.5))
        x = tokens.transpose(1, 2).reshape(b, c, size, size)
        out = self.transposed_convolution(x)[:, 0]
        return out.to(torch.promote_types(out.dtype, torch.float32))


class CLIPSegModel(nn.Module):
    """The text-prompted segmenter; forward returns [B, H, W] logits."""

    def __init__(self, vision_cfg: TowerConfig = CLIP_B16_VISION,
                 text_cfg: TowerConfig = CLIP_TEXT, projection_dim: int = 512,
                 extract_layers: Sequence[int] = (3, 6, 9), reduce_dim: int = 64,
                 decoder_heads: int = 4, decoder_intermediate: int = 2048):
        super().__init__()
        self.extract_layers = tuple(extract_layers)
        self.clip = CLIPModule(vision_cfg, text_cfg, projection_dim)
        self.decoder = CLIPSegDecoder(vision_cfg.hidden_size, projection_dim, reduce_dim,
                                      len(self.extract_layers), vision_cfg.patch_size,
                                      decoder_heads, decoder_intermediate)

    def logit_size(self, image_size: int) -> int:
        """Side of the logit grid for an image_size input: the patch grid
        times the transposed convolutions' strides (352 for 352 at patch
        16), with no forward."""
        size = image_size // self.clip.vision_model.cfg.patch_size
        for m in self.decoder.transposed_convolution:
            if isinstance(m, nn.ConvTranspose2d):
                size *= m.stride[0]
        return size

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The conditional (FiLM) embedding: projected pooled text features."""
        return self.clip.encode_text(input_ids)

    def forward(self, pixels: torch.Tensor, input_ids: Optional[torch.Tensor] = None,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pixels: NHWC CLIP-normalized (352x352); token ids or a
        precomputed conditional embedding [B or 1, projection_dim]."""
        with torch.no_grad():
            _, hidden = self.clip.vision_model(pixels, depth=max(self.extract_layers) + 1)
            acts = [hidden[i + 1] for i in self.extract_layers]
            if cond is None:
                if input_ids is None:
                    raise ValueError("need input_ids or cond")
                cond = self.encode_text(input_ids)
        if cond.shape[0] == 1 and pixels.shape[0] != 1:
            cond = cond.expand(pixels.shape[0], -1)
        return self.decoder(acts, cond)


@register_model("CLIPSeg", task="segmentation", needs_text_features=True,
                init_weights=init_weights)
def clipseg(device: DeviceLike = None, **kw) -> CLIPSegModel:
    """Randomly initialized on `device` from its global generator (seed
    it first); on the meta device, not initialized."""
    with torch.device(resolve_device(device)):  # initialized where it lives
        return CLIPSegModel(**kw)
