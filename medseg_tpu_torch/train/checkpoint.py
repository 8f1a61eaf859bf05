"""Checkpoints as torch files: the best model, and a full resume state.

Counterpart of medseg_tpu/train/checkpoint.py, which writes orbax trees:
- `save_best` writes `{save_dir}/{name}_best_acc.pt` for a classifier and
  `{save_dir}/{name}_best_loss.pt` for a segmentation model, the model's
  state dict under the reference's key names (utils/helpers.py:394-400,
  medseg_tpu/train/checkpoint.py:24-25).  It is the file both eval
  harnesses load (this package's eval/harness.py and the
  JAX package's medseg_tpu/eval/harness.py:55-58), so a model trained here
  is evaluated by either;
- `save_resume` / `load_resume` round-trip `{name}_resume.pt`: the model
  state, the optimizer's state_dict, the step count and the JAX package's
  meta fields (epoch, best_score, stage, plateau_lr).  It holds tensors and
  plain Python values only, so it loads with weights_only=True.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch
from torch import nn


def _cpu_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.cpu() for k, v in model.state_dict().items()}


def resume_path(save_dir: str, name: str) -> Path:
    return Path(save_dir) / f"{name}_resume.pt"


def save_best(save_dir: str, name: str, model: nn.Module, seg: bool = False) -> Path:
    path = Path(save_dir) / f"{name}_{'best_loss' if seg else 'best_acc'}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_cpu_state(model), path)
    return path


def save_resume(save_dir: str, name: str, model: nn.Module,
                optimizer: torch.optim.Optimizer, step: int, epoch: int,
                best_score: float, extra: Optional[Dict] = None) -> Path:
    path = resume_path(save_dir, name)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save({"model": _cpu_state(model),
                "optimizer": optimizer.state_dict(),
                "step": step,
                "meta": {"epoch": epoch, "best_score": best_score, **(extra or {})}},
               tmp)
    tmp.replace(path)  # a run cut while saving keeps the previous epoch's file
    return path


def load_resume(save_dir: str, name: str) -> Optional[Dict]:
    """The resume state ({"model", "optimizer", "step", "meta"}) on the
    CPU, or None when there is none."""
    path = resume_path(save_dir, name)
    if not path.exists():
        return None
    return torch.load(path, map_location="cpu", weights_only=True)
