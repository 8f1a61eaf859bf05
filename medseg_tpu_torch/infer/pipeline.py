"""The cascaded classify-then-segment inference pipeline (serving API).

Counterpart of medseg_tpu/infer/pipeline.py:46-299 (reference
utils/pipeline.py:178-418 `Pipeline`):

- `_load_models(cls_name, seg_name)`: lazy, cached by model name; missing
  classifier weights fall back to a fresh init (the registry's
  init_weights from a CPU generator seeded 0) with a warning, a
  segmentation model that fails to load yields a placeholder that skips
  segmentation.  CLIP takes its prompt features and CLIPSeg its
  conditional embedding from the checkpoint's own text tower
  (eval/harness.load_model_bundle) unless they were passed to the
  Pipeline; a fresh-initialized CLIP without passed features raises
  ValueError, as the JAX package does, and a CLIPSeg without an embedding
  becomes the placeholder.
- `process_batch(images, seg_name, overlay_opacity)`: each original is
  copied to the device and resized once, straight to the model's grid
  (uint8, `_to_grid`); one classification forward for the group, padded
  to a power of two; softmax confidence on the host; if any prediction is
  "COVID", one segmentation forward for the whole group, thresholded at
  0.5 on the host; the mask is nearest-resized to each original and
  blended red.  Log lines and the analysis text are the JAX package's,
  word for word.

Each forward is B2's eval form and the model in eval mode, float32 (the
factories' default), under torch.inference_mode, entered inside the call
because a server calls from its worker thread: for the CNNs
`preprocess_eval_batch` (ImageNet's mean and std), for CLIP and CLIPSeg
`clip_preprocess` at their grid size (CLIP's), each one launch of the
photometric kernel on the card.  Each forward reads its result back once
(logits, or probabilities [B,H,W,1]) and records the batch shapes it has
seen in `fn.seen_batches` (the analog of the JAX test's jit cache size).
The segmentation forward reuses the classification grid when both models
share it, where the JAX package resizes each original again.

Grids (`input_grid`): VGG's 224 (the reference's torchvision resize) and
the other CNNs' 256 are bilinear (cv2's convention, ops/image.py), CLIP's
224 and CLIPSeg's 352 bicubic as jax.image.resize computes it (their
processors' resample), each rounded to uint8.  A group whose two models
have different grids resizes each original twice, once per grid.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from medseg_tpu_torch.core.config import (CLASSES, CLIP_IMG_SIZE, CLIPSEG_IMG_SIZE,
                                          IMG_SIZE, EvalConfig)
from medseg_tpu_torch.core.device import DeviceLike, resolve_device
from medseg_tpu_torch.core.registry import get_model
from medseg_tpu_torch.eval.harness import load_model_bundle
from medseg_tpu_torch.infer.overlay import red_overlay
from medseg_tpu_torch.models.resnet import init_weights
from medseg_tpu_torch.ops.augment import preprocess_eval_batch
from medseg_tpu_torch.ops.clip_prep import clip_preprocess
from medseg_tpu_torch.ops.image import host_to_device, resize_bilinear, resize_jax


def _forward_fn(model: torch.nn.Module, seg: bool, clip_size: Optional[int] = None,
                **extra: torch.Tensor):
    """uint8 [B,H,W,3] on the model's device -> logits (classification) or
    float32 probabilities [B,H,W,1] (segmentation), on the device.
    clip_size: CLIP's or CLIPSeg's grid (clip_preprocess), None for the
    CNNs (preprocess_eval_batch); `extra` goes to the model (text_features
    for CLIP, cond for CLIPSeg)."""
    model.eval()

    def fn(images_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if clip_size is None:
                x, _ = preprocess_eval_batch(images_u8)
            else:
                x = clip_preprocess(images_u8, clip_size)
            out = model(x, **extra)
            if seg:
                out = torch.sigmoid(out.to(torch.float32))
                if out.dim() == 3:  # CLIPSeg's [B,H,W] logits
                    out = out[..., None]
        fn.seen_batches.add(tuple(images_u8.shape))
        return out

    fn.seen_batches = set()
    fn.model = model
    return fn


def build_model(name: str, state_dict, device: torch.device) -> torch.nn.Module:
    """The registry model, float32, holding `state_dict` (strict), on
    `device`; state_dict None draws a fresh init (the registry entry's
    init_weights, else models.resnet's) from a CPU generator seeded 0, the
    same weights on every device."""
    entry = get_model(name)
    model = entry["factory"](device="cpu")
    if state_dict is None:
        entry.get("init_weights", init_weights)(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device)


def model_forward(name: str, state_dict, extra: Dict[str, torch.Tensor], seg: bool,
                  device: torch.device):
    """_forward_fn of the registry model `name` holding `state_dict`, with
    CLIP's or CLIPSeg's extra inputs; raises ValueError, worded as the JAX
    package's, when CLIP has no text_features or CLIPSeg no cond."""
    lname = name.lower()
    if lname == "clip" and "text_features" not in extra:
        raise ValueError(
            "CLIP needs text_features: none embedded in the "
            "checkpoint and none passed to Pipeline(text_features=...)")
    if lname == "clipseg" and "cond" not in extra:
        raise ValueError(
            "CLIPSeg needs a conditional embedding: none embedded in "
            "the checkpoint and none passed to Pipeline(clipseg_cond=...)")
    extra = {k: torch.as_tensor(v).to(device) for k, v in extra.items()}
    clip_size = Pipeline.input_grid(name)[0] if lname in ("clip", "clipseg") else None
    return _forward_fn(build_model(name, state_dict, device), seg, clip_size, **extra)


class Pipeline:
    # largest micro-batch one forward serves; groups pad up to the next
    # power of two, so each model sees at most log2(MAX_BATCH)+1 shapes
    MAX_BATCH = 8

    def __init__(self, cfg: EvalConfig = EvalConfig(),
                 text_features: Optional[np.ndarray] = None,
                 clipseg_cond: Optional[np.ndarray] = None, device: DeviceLike = None):
        """text_features: [3, 512] normalized CLIP prompt features;
        clipseg_cond: [1, 512] CLIPSeg conditional embedding (precomputed,
        as the reference encodes its fixed prompts once, CLIP.py:36-45);
        either overrides the checkpoint's own.  device: the card unless
        "cpu" is passed; without a card it raises."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.text_features = text_features
        self.clipseg_cond = clipseg_cond
        self._cls: Optional[Tuple[str, object]] = None  # (name, fn)
        self._seg: Optional[Tuple[str, object]] = None  # fn None: placeholder

    # ------------------------------------------------------------------
    @staticmethod
    def input_grid(name: str) -> Tuple[int, str]:
        """(size, resample) of the grid each original is resized to, once:
        CLIP's 224 and CLIPSeg's 352 bicubic (their processors,
        medseg_tpu/infer/pipeline.py:61-74), VGG's 224 torchvision resize
        (reference pipeline.py:161-172), else the 256 Albumentations
        transform (pipeline.py:186-193).  Reads the sizes at call time, as
        the JAX package does."""
        lname = name.lower()
        if lname == "clip":
            return CLIP_IMG_SIZE, "bicubic"
        if lname == "clipseg":
            return CLIPSEG_IMG_SIZE, "bicubic"
        if lname.startswith("vgg"):
            return 224, "bilinear"
        return IMG_SIZE, "bilinear"

    def _load_models(self, classification_name: str, segmentation_name: str):
        if self._cls is None or self._cls[0].lower() != classification_name.lower():
            name = classification_name
            bundle = load_model_bundle(name, self.cfg.weights_root, False, self.device)
            if bundle is None:
                print("Weights file not found. Using fresh-initialized weights only.")
                state, extra = None, {}
            else:
                state, extra = bundle
            if self.text_features is None and "text_features" in extra:
                self.text_features = extra["text_features"]
            if self.text_features is not None and name.lower() == "clip":
                extra = {"text_features": self.text_features}
            self._cls = (name, model_forward(name, state, extra, False, self.device))
            print(f"Successfully loaded Classification Model: {name}")

        if self._seg is None or self._seg[0].lower() != segmentation_name.lower():
            name = segmentation_name
            try:
                bundle = load_model_bundle(name, self.cfg.weights_root, True, self.device)
                if bundle is None:
                    raise FileNotFoundError(name)
                state, extra = bundle
                if self.clipseg_cond is None and "cond" in extra:
                    self.clipseg_cond = extra["cond"]
                if self.clipseg_cond is not None and name.lower() == "clipseg":
                    extra = {"cond": self.clipseg_cond}
                self._seg = (name, model_forward(name, state, extra, True, self.device))
                print(f"Successfully loaded Segmentation Model: {name}")
            except Exception as e:
                print(f"CRITICAL ERROR: Failed to load segmentation weights for "
                      f"{name}. Error: {e}")
                self._seg = (name, None)  # placeholder: skip segmentation

    # ------------------------------------------------------------------
    @staticmethod
    def _to_grid(batch_u8: np.ndarray, size: int, device: torch.device,
                 method: str = "bilinear") -> torch.Tensor:
        """Host uint8 [N,H,W,3] -> uint8 [N,size,size,3] on `device`, one
        resample (bilinear, cv2's; or bicubic, jax.image.resize's), rounded
        half to even as jnp.round and clipped to [0, 255]; only the copy
        when the batch is already at the grid size."""
        x = host_to_device(batch_u8, device)
        if x.shape[1] == size and x.shape[2] == size:
            return x
        if method == "bicubic":
            x = resize_jax(x, size, size, "bicubic")
        else:
            x = resize_bilinear(x, size, size)
        return x.round_().clamp_(0, 255).to(torch.uint8)

    @classmethod
    def _grid_batch(cls, arrays, size: int, device: torch.device,
                    method: str = "bilinear") -> torch.Tensor:
        """Each original resized on its own to the grid, stacked."""
        return torch.cat([cls._to_grid(a[None], size, device, method) for a in arrays])

    @staticmethod
    def _pad_pow2(x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        target = 1
        while target < n:
            target *= 2
        if target == n:
            return x
        return torch.cat([x, x[-1:].expand(target - n, *x.shape[1:])])

    @classmethod
    def _forward(cls, fn, grid: torch.Tensor) -> np.ndarray:
        """One forward of the padded group, read back once, trimmed."""
        return fn(cls._pad_pow2(grid)).cpu().numpy()[:grid.shape[0]]

    def _predict_classification(self, images_u8: torch.Tensor) -> Tuple[str, float]:
        if self._cls is None:
            return "FATAL ERROR: Classification Model Not Loaded", 0.0
        logits = self._cls[1](images_u8).cpu().numpy()[0]
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        idx = int(np.argmax(probs))
        return CLASSES[idx], float(probs[idx]) * 100.0

    def _predict_segmentation(self, images_u8: torch.Tensor) -> Optional[np.ndarray]:
        if self._seg is None or self._seg[1] is None:
            return None
        probs = self._seg[1](images_u8).cpu().numpy()[0, :, :, 0]
        return (probs > self.cfg.threshold).astype(np.uint8) * 255

    def process_image(self, image, segmentation_model_name: str,
                      overlay_opacity: float = 0.5):
        """image: RGB uint8 array or PIL Image.
        Returns (prediction, confidence, overlay_or_None, analysis_text)."""
        return self.process_batch([image], segmentation_model_name,
                                  overlay_opacity)[0]

    def process_batch(self, images, segmentation_model_name: str,
                      overlay_opacity: float = 0.5):
        """Micro-batched cascade over up to MAX_BATCH images: one
        classification forward for the group and (if any prediction is
        COVID) one segmentation forward for the whole group; overlays are
        rendered only for COVID.  Entries are RGB uint8 arrays, PIL images
        or None.
        Returns a list of (prediction, confidence, overlay, analysis)."""
        results: list = [None] * len(images)
        arrays, idxs = [], []
        for i, image in enumerate(images):
            if image is None:
                results[i] = ("No Image Uploaded", 0.0, None,
                              "Please upload an image to begin analysis.")
                continue
            if not isinstance(image, np.ndarray):
                image = np.asarray(image.convert("RGB"))
            arrays.append(image)
            idxs.append(i)
        if not arrays:
            return results

        cls_name = self._cls[0] if self._cls else "ResNet50"
        self._load_models(cls_name, segmentation_model_name)

        grid = self.input_grid(self._cls[0])
        cls_in = self._grid_batch(arrays, *grid[:1], self.device, grid[1])
        logits = self._forward(self._cls[1], cls_in)
        probs = np.exp(logits - logits.max(axis=-1, keepdims=True))
        probs /= probs.sum(axis=-1, keepdims=True)
        pred_idx = probs.argmax(axis=-1)
        preds = [CLASSES[int(k)] for k in pred_idx]
        confs = [float(probs[j, k]) * 100.0 for j, k in enumerate(pred_idx)]

        masks = [None] * len(arrays)
        if self._seg[1] is not None and "COVID" in preds:
            s_grid = self.input_grid(self._seg[0])
            seg_in = (cls_in if s_grid == grid
                      else self._grid_batch(arrays, s_grid[0], self.device, s_grid[1]))
            sp = self._forward(self._seg[1], seg_in)[..., 0]
            masks = [(p > self.cfg.threshold).astype(np.uint8) * 255 for p in sp]

        for j, i in enumerate(idxs):
            prediction, confidence = preds[j], confs[j]
            analysis = (f"Diagnosis: {prediction}\n"
                        f"Confidence: {confidence:.2f}%\n")
            output_img = None
            if prediction != "COVID":  # cascade gate (pipeline.py:395-396)
                analysis += ("\nRecommendation: Consult a medical professional "
                             "for final diagnosis. The model suggests no severe "
                             "COVID-19 pathology.")
            elif masks[j] is not None:
                output_img = red_overlay(arrays[j], masks[j], overlay_opacity)
                analysis += ("\nInfection areas have been highlighted in red "
                             "(segmentation model).")
            else:
                analysis += ("\nWARNING: Segmentation model failed to load. "
                             "Cannot highlight infection areas.")
            results[i] = (prediction, confidence, output_img, analysis)
        return results
