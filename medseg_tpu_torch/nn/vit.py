"""CLIP-style transformer towers under HF's module names.

Counterpart of medseg_tpu/nn/vit.py:29-197 (the math of HF `CLIPModel`,
openai/clip-vit-base-patch32, and the backbone of
`CLIPSegForImageSegmentation`):

- vision tower: patch embedding (a conv without bias, stride = kernel) +
  CLS + learned positions, bicubically interpolated off the native grid as
  CLIPSeg runs at 352; `pre_layrnorm`, pre-norm encoder layers with a
  quick-gelu MLP, and the pooled CLS after `post_layernorm`;
- text tower: token + position embeddings, causal pre-norm layers,
  `final_layer_norm`, pooled at the first `eos_token_id`;
- attention: q, k, v and out projections with biases, softmax(q k^T /
  sqrt(head_dim)) v by F.scaled_dot_product_attention (the JAX package's
  jax.nn.dot_product_attention, computed by XLA: no TPU kernel is replaced
  here, nor by the Linear GEMMs).

Module names are HF's (`embeddings.patch_embedding`, `pre_layrnorm` as HF
spells it, `encoder.layers.{i}.self_attn.{q,k,v,out}_proj`, `layer_norm1/2`,
`mlp.fc1/fc2`, `final_layer_norm`), so a slice of an HF state dict loads
with strict=True; HF's `position_ids` buffers are not persistent and take
no key.  Everything computes in float32.  Inputs are NHWC, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from medseg_tpu_torch.ops.image import resize_jax


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    # vision-only
    image_size: int = 224
    patch_size: int = 32
    # text-only
    vocab_size: int = 49408
    max_positions: int = 77
    eos_token_id: int = 49407


# ViT-B/32 CLIP (openai/clip-vit-base-patch32)
CLIP_B32_VISION = TowerConfig(768, 12, 12, 3072, image_size=224, patch_size=32)
CLIP_TEXT = TowerConfig(512, 12, 8, 2048)
# ViT-B/16 backbone of CIDAS/clipseg-rd64-refined (positions trained at 224,
# run at 352 through interpolation)
CLIP_B16_VISION = TowerConfig(768, 12, 12, 3072, image_size=224, patch_size=16)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


_ACTIVATIONS = {"quick_gelu": quick_gelu, "relu": F.relu}


class Attention(nn.Module):
    """Multi-head attention over [B, S, hidden]; `causal` masks the future."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, s, hidden = x.shape

        def heads(t):
            return t.view(b, s, self.heads, hidden // self.heads).transpose(1, 2)

        out = F.scaled_dot_product_attention(
            heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x)),
            is_causal=causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, hidden))


class MLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int, act: str = "quick_gelu"):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)
        self.act = _ACTIVATIONS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class EncoderLayer(nn.Module):
    """Pre-norm (the CLIP towers) or post-norm (CLIPSeg's decoder) block."""

    def __init__(self, cfg: TowerConfig, post_norm: bool = False):
        super().__init__()
        self.post_norm = post_norm
        self.self_attn = Attention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = MLP(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        if self.post_norm:
            x = self.layer_norm1(x + self.self_attn(x, causal))
            return self.layer_norm2(x + self.mlp(x))
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class Encoder(nn.Module):
    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))


class VisionEmbeddings(nn.Module):
    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.cfg = cfg
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         cfg.patch_size, bias=False)
        native = cfg.image_size // cfg.patch_size
        self.position_embedding = nn.Embedding(native * native + 1, cfg.hidden_size)

    def patches(self, pixels: torch.Tensor) -> torch.Tensor:
        """The patch conv, NHWC [B,H,W,3] -> [B, grid*grid, hidden], as the
        GEMM it is (stride = kernel, no padding): each patch's p*p*3 values
        in the weight's (C, kh, kw) order against weight [hidden, 3*p*p].
        cuDNN's own pick for this conv, with TF32 off, may be far slower."""
        b, h, w, c = pixels.shape
        p = self.cfg.patch_size
        gh, gw = h // p, w // p
        x = pixels[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, c)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, gh * gw, c * p * p)
        return x @ self.patch_embedding.weight.reshape(self.cfg.hidden_size, -1).t()

    def positions(self, grid: int) -> torch.Tensor:
        """[1 + grid*grid, hidden] position embeddings: bicubic resampling
        of the patch positions to a new grid as jax.image.resize computes
        it (HF CLIPSegVisionEmbeddings.interpolate_pos_encoding)."""
        pos = self.position_embedding.weight
        native = self.cfg.image_size // self.cfg.patch_size
        if grid == native:
            return pos
        patch = pos[1:].reshape(1, native, native, -1)
        patch = resize_jax(patch, grid, grid, "bicubic")
        return torch.cat([pos[:1], patch.reshape(grid * grid, -1)])

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.patches(pixels)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.positions(pixels.shape[1] // self.cfg.patch_size)


class VisionTower(nn.Module):
    """CLIP's vision transformer; forward returns (pooled, hidden_states).

    hidden_states[0] is the embeddings after pre_layrnorm and
    hidden_states[i] the output of layer i, as HF's output_hidden_states
    indexes them.  `depth` runs only the first `depth` layers and then
    returns no pooled output (CLIPSeg reads layers up to its deepest
    extract layer; the JAX program's unused later layers are removed by
    XLA)."""

    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor, depth: Optional[int] = None
                ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
        """pixels: NHWC float32, CLIP-normalized."""
        x = self.pre_layrnorm(self.embeddings(pixels))
        hidden_states = [x]
        layers = self.encoder.layers
        for layer in layers if depth is None else layers[:depth]:
            x = layer(x)
            hidden_states.append(x)
        pooled = None if depth is not None else self.post_layernorm(x[:, 0])
        return pooled, hidden_states


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return (self.token_embedding(input_ids)
                + self.position_embedding.weight[:input_ids.shape[1]])


class TextTower(nn.Module):
    """CLIP's text transformer; returns the pooled (pre-projection)
    embedding at each row's first `eos_token_id`."""

    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = TextEmbeddings(cfg)
        self.encoder = Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: integer [B, S] (made int64 for nn.Embedding)."""
        input_ids = input_ids.to(torch.int64)
        x = self.embeddings(input_ids)
        for layer in self.encoder.layers:
            x = layer(x, causal=True)
        x = self.final_layer_norm(x)
        eos = (input_ids == self.cfg.eos_token_id).to(torch.int32).argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eos]
