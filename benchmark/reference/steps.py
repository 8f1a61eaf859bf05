"""The reference's training steps and eval forward, in plain PyTorch.

`follow` runs the recipe's steps on the given global batches from the
given weights and the generator seed the program's steps drew from: the
augmentation (reference/augment.py), the train-mode forward (the head's
dropout drawn after the augmentation), the loss (label-smoothed
cross-entropy, or binary cross-entropy with logits over every value), the
backward, the global-norm clip (scale max_norm/|g| where |g| >= max_norm)
and AdamW (decoupled weight decay, bias-corrected moments), written out.
It returns what the program's first steps are compared on: the loss of
each group of steps, the norm of every trainable leaf's first (clipped)
gradient (the norm of AdamW's first moment over 1 - beta1 after the first
group of steps: with a group of one step, the clipped gradient itself), and
the norm of every trainable leaf's change over the steps.

`logits` runs the eval-mode forward in blocks of rows.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import augment as A
from benchmark.harness.manifest import reference
from benchmark.reference.precision import QUANT, float32


def _trainable(config: dict, name: str) -> bool:
    frozen = config["recipe"].get("frozen_prefixes", [])
    return not any(name.split(".", 1)[0] == p for p in frozen)


def follow(config: dict, weights: Dict[str, torch.Tensor],
           batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], gen_seed: int,
           groups: Sequence[int], lr: float, precision: str = "float32",
           fault: str = None, world: int = 1) -> dict:
    """batches: [(uint8 images [B,H,W,3], labels [B] or uint8 masks
    [B,H,W])] on the device, one a step; groups: how many steps each loss
    reading averages (sum(groups) steps are followed).

    fault: a fault planted in the reference put in the program's place, to
    read what a faulty program would read: "half" takes the loss's mean
    over the first half of each batch; "local" follows the first of
    `world` ranks with no exchange (its rows of the global batch and of
    the global draws, its own BatchNorm statistics and gradient)."""
    recipe = config["recipe"]
    seg = config["task"] == "segmentation"
    dev = batches[0][0].device
    models = reference(config)
    model = models.build(config, dev)
    model.load_state_dict(weights, strict=True)
    models.set_quant(model, QUANT[precision])
    model.train()
    params = {k: p for k, p in model.named_parameters()}
    train = {k: p for k, p in params.items() if _trainable(config, k)}
    for k, p in params.items():
        p.requires_grad_(k in train)
    start = {k: p.detach().clone() for k, p in train.items()}
    m1 = {k: torch.zeros_like(p) for k, p in train.items()}
    m2 = {k: torch.zeros_like(p) for k, p in train.items()}
    b1, b2, eps = recipe["betas"][0], recipe["betas"][1], recipe["eps"]
    wd, clip = recipe["weight_decay"], recipe["clip_norm"]
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    losses: List[float] = []
    grad1 = None
    with float32():
        for t, (images, target) in enumerate(batches[:sum(groups)], start=1):
            rows = images.shape[0]
            d = A.draw(gen, rows)
            if fault == "local":
                rows //= world
                images, target = images[:rows], target[:rows]
                d = A.Draw(*(v[:rows] for v in d))
            x, m = A.augment(images, d, target if seg else None)
            n = rows // 2 if fault == "half" else rows
            if seg:
                loss = F.binary_cross_entropy_with_logits(model(x)[:n], m[:n])
            else:
                p = config["architecture"]["dropout"]
                keep = A.dropout_keep(gen, images.shape[0] * (world if fault == "local" else 1),
                                      model.fc[1].in_features, p)[:rows]
                loss = F.cross_entropy(model(x, keep)[:n], target[:n].long(),
                                       label_smoothing=recipe["label_smoothing"])
            for p in train.values():
                p.grad = None
            loss.backward()
            losses.append(float(loss.detach()))
            with torch.no_grad():
                g = {k: p.grad for k, p in train.items()}
                norm = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(v) for v in g.values()]))
                scale = torch.where(norm < clip, 1.0, clip / norm)
                g = {k: v * scale for k, v in g.items()}
                for k, p in train.items():
                    p.mul_(1.0 - lr * wd)
                    m1[k].mul_(b1).add_(g[k], alpha=1 - b1)
                    m2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                    denom = (m2[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                    p.addcdiv_(m1[k], denom, value=-lr / (1 - b1 ** t))
                if t == groups[0]:  # the first moment after the first group of steps
                    grad1 = {k: float(torch.linalg.vector_norm(v)) / (1 - b1)
                             for k, v in m1.items()}
    out, i = [], 0
    for n in groups:
        out.append(sum(losses[i:i + n]) / n)
        i += n
    change = {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
              for k, p in train.items()}
    return {"loss": out, "grad": grad1, "change": change}


@torch.no_grad()
def logits(config: dict, weights: Dict[str, torch.Tensor], images: torch.Tensor,
           precision: str = "float32", block: int = 128) -> torch.Tensor:
    """float32 eval-mode logits [N, classes] of uint8 images [N,H,W,3]."""
    models = reference(config)
    model = models.build(config, images.device)
    model.load_state_dict(weights, strict=True)
    models.set_quant(model, QUANT[precision])
    model.eval()
    with float32(tf32=precision == "tf32"):
        return torch.cat([model(A.eval_preprocess(images[s:s + block])).float()
                          for s in range(0, images.shape[0], block)])
