"""Checkpoints as torch files: the best model, and a full resume state.

Counterpart of medseg_tpu/train/checkpoint.py, which writes orbax trees:
- `save_best` writes `{save_dir}/{name}_best_acc.pt` for a classifier and
  `{save_dir}/{name}_best_loss.pt` for a segmentation model, the model's
  state dict under the reference's key names (utils/helpers.py:394-400,
  medseg_tpu/train/checkpoint.py:24-25).  It is the file both eval
  harnesses load (this package's eval/harness.py and the
  JAX package's medseg_tpu/eval/harness.py:55-58), so a CNN trained here
  is evaluated by either.  The finetuners add `aux`, the small tensors
  CLIP and CLIPSeg take at inference (the prompt features, the
  conditional embedding), as JAX's aux subtree (:55-72): each under the
  reserved key `aux.<name>` beside the HF-named state dict, split off by
  `split_aux` before a strict load.  `meta` goes to a JSON file beside
  the .pt (`{name}_best_acc.meta.json`).  The JAX harness reads only
  full HF state dicts for CLIP and CLIPSeg, so a finetuned CLIP or
  CLIPSeg file is this package's to load;
- `save_resume` / `load_resume` round-trip `{name}_resume.pt`: the model
  state, the optimizer's state_dict, the step count and the JAX package's
  meta fields (epoch, best_score, stage, plateau_lr).  It holds tensors and
  plain Python values only, so it loads with weights_only=True.

Under data parallelism (`group`, a parallel.DataParallelGroup) rank 0
writes and every rank then waits at a barrier, so no rank reads a file
before it is whole; on resume every rank reads.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn


def _cpu_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.cpu() for k, v in model.state_dict().items()}


def resume_path(save_dir: str, name: str) -> Path:
    return Path(save_dir) / f"{name}_resume.pt"


AUX_PREFIX = "aux."


def _rank0_writes(group, write) -> None:
    """write() on rank 0 (or without a group), then a barrier."""
    if group is None or group.rank == 0:
        write()
    if group is not None:
        group.barrier()


def save_best(save_dir: str, name: str, model: nn.Module, seg: bool = False,
              meta: Optional[Dict] = None,
              aux: Optional[Mapping[str, torch.Tensor]] = None, group=None) -> Path:
    """aux: small non-parameter tensors the model needs at inference,
    stored as `aux.<name>` float32 tensors; meta: a JSON sidecar."""
    path = Path(save_dir) / f"{name}_{'best_loss' if seg else 'best_acc'}.pt"

    def write():
        path.parent.mkdir(parents=True, exist_ok=True)
        state = _cpu_state(model)
        for k, v in (aux or {}).items():
            state[AUX_PREFIX + k] = torch.as_tensor(v, dtype=torch.float32).cpu()
        torch.save(state, path)
        if meta is not None:
            path.with_suffix(".meta.json").write_text(json.dumps(meta))

    _rank0_writes(group, write)
    return path


def split_aux(sd: Mapping[str, torch.Tensor]
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(the state dict without its aux keys, {name: aux tensor})."""
    state = {k: v for k, v in sd.items() if not k.startswith(AUX_PREFIX)}
    aux = {k[len(AUX_PREFIX):]: v for k, v in sd.items() if k.startswith(AUX_PREFIX)}
    return state, aux


def save_resume(save_dir: str, name: str, model: nn.Module,
                optimizer: torch.optim.Optimizer, step: int, epoch: int,
                best_score: float, extra: Optional[Dict] = None, group=None) -> Path:
    path = resume_path(save_dir, name)

    def write():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        torch.save({"model": _cpu_state(model),
                    "optimizer": optimizer.state_dict(),
                    "step": step,
                    "meta": {"epoch": epoch, "best_score": best_score, **(extra or {})}},
                   tmp)
        tmp.replace(path)  # a run cut while saving keeps the previous epoch's file

    _rank0_writes(group, write)
    return path


def load_resume(save_dir: str, name: str) -> Optional[Dict]:
    """The resume state ({"model", "optimizer", "step", "meta"}) on the
    CPU, or None when there is none."""
    path = resume_path(save_dir, name)
    if not path.exists():
        return None
    return torch.load(path, map_location="cpu", weights_only=True)
