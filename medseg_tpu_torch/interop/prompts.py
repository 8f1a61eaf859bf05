"""Prompt token ids: the constants that make CLIP and CLIPSeg drivable
offline.

Counterpart of medseg_tpu/interop/prompts.py.  The reference's prompts are
four fixed strings (models/classification_models/CLIP.py:10-14,
segmentation_models/CLIPSeg.py:10), so their BPE token ids are constants,
resolved from, in order:

  1. `$MEDSEG_PROMPT_IDS`: the path of a JSON bundle (schema below);
  2. `prompt_token_ids.json` next to this file, where one is shipped;
  3. live tokenization by interop/clip_tokenizer.py (needs the BPE tables).

The JAX package's fourth route, transformers' CLIPTokenizer, needs HF
assets and is left out.  The repository ships no bundle yet, so the
reference's real prompts cannot be tokenized on a machine without the
vocabulary; any bundle of the schema drives the port (chip_smoke.py writes
one with arbitrary ids).

Bundle schema:
  {"prompts": [...the 4 strings...],
   "clip": [[ids...], [ids...], [ids...]],     # EOT-padded to equal length
   "clipseg": [[ids...]]}

Generate with:  python -m medseg_tpu_torch.interop.prompts --write
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from medseg_tpu_torch.core.config import DEFAULT_SEG_TEXT_PROMPT, DEFAULT_TEXT_PROMPTS

BUNDLED_IDS_PATH = Path(__file__).with_name("prompt_token_ids.json")
ALL_PROMPTS = tuple(DEFAULT_TEXT_PROMPTS) + (DEFAULT_SEG_TEXT_PROMPT,)


class PromptIdsUnavailable(RuntimeError):
    pass


def _from_json(path: Path) -> Dict[str, np.ndarray]:
    data = json.loads(path.read_text())
    if tuple(data.get("prompts", ())) != ALL_PROMPTS:
        raise PromptIdsUnavailable(
            f"{path} was generated for different prompts; regenerate with "
            f"`python -m medseg_tpu_torch.interop.prompts --write`")
    return {"clip": np.asarray(data["clip"], np.int32),
            "clipseg": np.asarray(data["clipseg"], np.int32)}


def _from_tokenizer() -> Dict[str, np.ndarray]:
    from medseg_tpu_torch.interop.clip_tokenizer import ClipTokenizer

    tok = ClipTokenizer()
    return {"clip": tok(list(DEFAULT_TEXT_PROMPTS)),
            "clipseg": tok([DEFAULT_SEG_TEXT_PROMPT])}


def get_prompt_token_ids() -> Dict[str, np.ndarray]:
    """{'clip': [3, L] ids, 'clipseg': [1, L'] ids} for the default prompts."""
    env = os.environ.get("MEDSEG_PROMPT_IDS")
    if env:
        return _from_json(Path(env))
    if BUNDLED_IDS_PATH.exists():
        return _from_json(BUNDLED_IDS_PATH)
    try:
        return _from_tokenizer()
    except (OSError, ImportError) as e:
        raise PromptIdsUnavailable(
            "prompt token ids unavailable offline: no bundled "
            f"{BUNDLED_IDS_PATH.name}, no $MEDSEG_PROMPT_IDS, and no BPE "
            "vocabulary to tokenize with. On any machine with the "
            "openai/clip-vit-base-patch32 tokenizer, run `python -m "
            "medseg_tpu_torch.interop.prompts --write` and ship the JSON. "
            f"Details: {type(e).__name__}: {e}") from e


def write_bundle(out_path: Optional[str] = None) -> Path:
    """Tokenize the default prompts and write the JSON bundle."""
    ids = _from_tokenizer()
    path = Path(out_path or BUNDLED_IDS_PATH)
    path.write_text(json.dumps({"prompts": list(ALL_PROMPTS),
                                "clip": ids["clip"].tolist(),
                                "clipseg": ids["clipseg"].tolist()}, indent=1))
    return path


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.write:
        print(f"wrote {write_bundle(args.out)}")
    else:
        for k, v in get_prompt_token_ids().items():
            print(k, v.tolist())
