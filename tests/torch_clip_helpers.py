"""Shared set-up of the CLIP tests (test_torch_clip.py,
test_torch_clip_infer.py): the tiny tower configs of
tests/test_interop.py:_tower_cfgs in both packages, flax-initialized tiny
CLIP and CLIPSeg variables carried to the reference's HF-named `.pt`
through the port's interop/from_jax, a prompt-ids bundle of arbitrary ids
for the tiny vocabulary, and a context that patches the tiny models and
grids into both packages' registries, converters and pipelines."""

import contextlib
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medseg_tpu.core.config as jconfig
import medseg_tpu.core.registry as jregistry
import medseg_tpu.interop.hf_clip as jhf_clip
import medseg_tpu.models.clip as jclip
import medseg_tpu.models.clipseg as jclipseg
import medseg_tpu_torch.core.config as tconfig
import medseg_tpu_torch.core.registry as tregistry
import medseg_tpu_torch.interop.text_features as ttext
from medseg_tpu.infer import batch as jbatch
from medseg_tpu.infer import pipeline as jpipeline
from medseg_tpu.nn.vit import TowerConfig as JTowerConfig
from medseg_tpu_torch.infer import pipeline as tpipeline
from medseg_tpu_torch.interop.from_jax import clip_state_dict, clipseg_state_dict
from medseg_tpu_torch.models.clip import CLIPClassifier, CLIPModule
from medseg_tpu_torch.models.clipseg import CLIPSegModel
from medseg_tpu_torch.nn.vit import TowerConfig

VISION = dict(hidden_size=40, num_layers=2, num_heads=2, intermediate_size=80,
              image_size=32, patch_size=8)
TEXT = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            vocab_size=100, max_positions=16, eos_token_id=99)
PROJ = 24
SEG = dict(extract_layers=(0, 1), reduce_dim=16, decoder_heads=2, decoder_intermediate=32)
CLIP_GRID, CLIPSEG_GRID = 32, 48  # CLIPSeg's 48px at patch 8: positions 4x4 -> 6x6
# arbitrary ids ending in eos 99 (98: start, 97 pads one row past its eos)
PROMPT_IDS = {"clip": [[98, 5, 7, 99], [98, 9, 99, 97], [98, 11, 2, 99]],
              "clipseg": [[98, 5, 99]]}

JV, JT = JTowerConfig(**VISION), JTowerConfig(**TEXT)
TV, TT = TowerConfig(**VISION), TowerConfig(**TEXT)


class JTinyCLIP(jclip.CLIPModule):
    vision_cfg: JTowerConfig = JV
    text_cfg: JTowerConfig = JT
    projection_dim: int = PROJ


class JTinyClassifier(jclip.CLIPClassifier):
    vision_cfg: JTowerConfig = JV
    projection_dim: int = PROJ


class JTinyCLIPSeg(jclipseg.CLIPSegModel):
    vision_cfg: JTowerConfig = JV
    text_cfg: JTowerConfig = JT
    projection_dim: int = PROJ
    extract_layers: tuple = SEG["extract_layers"]
    reduce_dim: int = SEG["reduce_dim"]
    decoder_heads: int = SEG["decoder_heads"]
    decoder_intermediate: int = SEG["decoder_intermediate"]


def tiny_clip_module(**_):
    return CLIPModule(TV, TT, PROJ)


def tiny_classifier(num_classes=3, device=None, **_):
    return CLIPClassifier(TV, PROJ).to(device or "cpu")


def tiny_clipseg(device=None, **_):
    return CLIPSegModel(TV, TT, PROJ, **SEG).to(device or "cpu")


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def clip_variables(seed: int = 0):
    """flax init of the tiny CLIPModule (both towers)."""
    ids = jnp.asarray(PROMPT_IDS["clip"], jnp.int32)
    return _numpy(JTinyCLIP().init(jax.random.key(seed),
                                   jnp.zeros((1, CLIP_GRID, CLIP_GRID, 3)), ids))


@functools.lru_cache(maxsize=None)
def clipseg_variables(seed: int = 1):
    """flax init of the tiny CLIPSegModel (text tower included)."""
    ids = jnp.asarray(PROMPT_IDS["clipseg"], jnp.int32)
    return _numpy(JTinyCLIPSeg().init(jax.random.key(seed),
                                      jnp.zeros((1, CLIPSEG_GRID, CLIPSEG_GRID, 3)), ids))


def write_clip_weights(root, clip=True, clipseg=True):
    """CLIP_best_acc.pt (a full CLIPModel state dict) and/or
    CLIPSeg_best_loss.pt under `root`, from the flax variables."""
    if clip:
        (root / "classification_models").mkdir(parents=True, exist_ok=True)
        torch.save(clip_state_dict(clip_variables()),
                   root / "classification_models" / "CLIP_best_acc.pt")
    if clipseg:
        (root / "segmentation_models").mkdir(parents=True, exist_ok=True)
        torch.save(clipseg_state_dict(clipseg_variables()),
                   root / "segmentation_models" / "CLIPSeg_best_loss.pt")
    return root


def write_prompt_ids(path):
    from medseg_tpu_torch.interop.prompts import ALL_PROMPTS

    path.write_text(json.dumps({"prompts": list(ALL_PROMPTS), **PROMPT_IDS}))
    return path


@contextlib.contextmanager
def tiny_clip_patched(tmp_path):
    """The tiny models and grids in both packages: registry factories, the
    JAX converters' layer counts, the text-feature modules, CLIP_IMG_SIZE
    and CLIPSEG_IMG_SIZE in the config and pipeline modules, and
    $MEDSEG_PROMPT_IDS."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jregistry._REGISTRY["clip"], "factory", lambda **_: JTinyClassifier())
        mp.setitem(jregistry._REGISTRY["clipseg"], "factory", lambda **_: JTinyCLIPSeg())
        mp.setattr(jhf_clip, "convert_clip", functools.partial(jhf_clip.convert_clip,
                                                               num_layers=2))
        mp.setattr(jhf_clip, "convert_clipseg", functools.partial(
            jhf_clip.convert_clipseg, num_layers=2, extract_depth=2))
        mp.setattr(jclip, "CLIPModule", JTinyCLIP)
        mp.setattr(jclipseg, "CLIPSegModel", JTinyCLIPSeg)
        tregistry._ensure_zoo_loaded()
        mp.setitem(tregistry._REGISTRY["clip"], "factory", tiny_classifier)
        mp.setitem(tregistry._REGISTRY["clipseg"], "factory", tiny_clipseg)
        mp.setattr(ttext, "CLIPModule", tiny_clip_module)
        mp.setattr(ttext, "CLIPSegModel", lambda: CLIPSegModel(TV, TT, PROJ, **SEG))
        for module in (jconfig, tconfig, jpipeline, tpipeline, jbatch):
            mp.setattr(module, "CLIP_IMG_SIZE", CLIP_GRID)
            mp.setattr(module, "CLIPSEG_IMG_SIZE", CLIPSEG_GRID)
        mp.setenv("MEDSEG_PROMPT_IDS", str(write_prompt_ids(tmp_path / "prompt_ids.json")))
        yield
