"""Text features and conditional embeddings from a checkpoint's own text
tower: no network and no HF assets.

Counterpart of medseg_tpu/interop/text_features.py:25-88.  The reference
evaluates CLIP and CLIPSeg from weight files alone (utils/tester.py:559-565,
642-648): the saved state dicts hold the full text towers, and the prompts
are fixed strings whose ids interop/prompts.py resolves.  These helpers run
the checkpoint's text tower once, on `device`, and return the small tensors
the image-side models take:

- CLIP: L2-normalized [N, 512] prompt features (CLIP.py:36-45);
- CLIPSeg: the unnormalized [1, 512] conditional embedding (HF
  get_conditional_embeddings), which FiLM takes.

The models are built on the meta device and take the state dict's tensors
(load_state_dict(assign=True), strict), so no random initialization runs;
only the text tower and its projection move to `device`.  Keys of HF's
`position_ids` buffers, persistent in older transformers releases, are
dropped first, as the JAX package's converters ignore them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.models.clip import CLIPModule
from medseg_tpu_torch.models.clipseg import CLIPSegModel

StateDict = Dict[str, torch.Tensor]


def hf_state_dict(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """An HF state dict without its `position_ids` buffers."""
    return {k: v for k, v in sd.items() if not k.endswith("position_ids")}


def _load(model_cls, sd: Mapping[str, torch.Tensor]):
    with torch.device("meta"):
        model = model_cls()
    model.load_state_dict(hf_state_dict(sd), strict=True, assign=True)
    return model.eval()


def _encode_text(clip: CLIPModule, token_ids, device: torch.device) -> torch.Tensor:
    clip.text_model.to(device)
    clip.text_projection.to(device)
    ids = torch.as_tensor(np.asarray(token_ids), dtype=torch.int64).to(device)
    with torch.inference_mode():
        return clip.encode_text(ids).to(torch.float32)


def clip_text_features(full_sd: Mapping[str, torch.Tensor], token_ids,
                       device: DeviceLike = None) -> torch.Tensor:
    """[N, 512] L2-normalized prompt features on `device` (the card unless
    "cpu"), from an HF CLIPModel state dict."""
    feats = _encode_text(_load(CLIPModule, full_sd), token_ids, resolve_device(device))
    return feats / feats.norm(dim=-1, keepdim=True)


def clipseg_cond(sd: Mapping[str, torch.Tensor], token_ids,
                 device: DeviceLike = None) -> torch.Tensor:
    """[1, 512] conditional embedding on `device`, from an HF
    CLIPSegForImageSegmentation state dict."""
    return _encode_text(_load(CLIPSegModel, sd).clip, token_ids, resolve_device(device))


def classifier_state_dict(full_sd: Mapping[str, torch.Tensor]) -> StateDict:
    """HF CLIPModel state dict -> the image-side CLIPClassifier's: the
    vision tower, visual_projection and logit_scale."""
    keep = ("vision_model.", "visual_projection.", "logit_scale")
    return {k: v for k, v in hf_state_dict(full_sd).items() if k.startswith(keep)}


def clip_bundle_from_torch_sd(sd: Mapping[str, torch.Tensor],
                              token_ids: Optional[np.ndarray] = None,
                              device: DeviceLike = None) -> Tuple[StateDict, torch.Tensor]:
    """Reference CLIP_best_acc.pt (a full HF CLIPModel state dict,
    utils/clip_finetuner.py:179) -> (CLIPClassifier state dict, normalized
    text features on `device`), offline."""
    if token_ids is None:
        from medseg_tpu_torch.interop.prompts import get_prompt_token_ids

        token_ids = get_prompt_token_ids()["clip"]
    return classifier_state_dict(sd), clip_text_features(sd, token_ids, device)


def clipseg_bundle_from_torch_sd(sd: Mapping[str, torch.Tensor],
                                 token_ids: Optional[np.ndarray] = None,
                                 device: DeviceLike = None) -> Tuple[StateDict, torch.Tensor]:
    """Reference CLIPSeg_best_loss.pt (a full HF CLIPSegForImageSegmentation
    state dict, utils/clip_seg_finetuner.py:240-246) -> (CLIPSegModel state
    dict, conditional embedding on `device`), offline."""
    if token_ids is None:
        from medseg_tpu_torch.interop.prompts import get_prompt_token_ids

        token_ids = get_prompt_token_ids()["clipseg"]
    return hf_state_dict(sd), clipseg_cond(sd, token_ids, device)
