"""Inputs made from the run's seed: sub-seeds, the synthetic images and the weights.

Images follow the recipe of the program's synthetic datasets
(medseg_tpu_torch/data/synthetic.py), frozen here: a classification image
is a class-separable blob, 20 + label*100 plus uniform noise in [0, 40)
on each value, clipped to 255; a segmentation image is uniform noise in
[0, 60) with one bright square of half the image's side at a uniform
position, filled with one value in [180, 255), and its mask is that square
(0/255).  Labels follow the database's class ratio.  They are drawn with
torch on the device, in chunks: numpy's draws of 12k images would take
tens of gigabytes and seconds of host time in every run.  A training
split stays on the device (`device_dataset`), where the loader's device
cache holds it; an evaluation split goes to the host (`dataset`), where
the loader without a device cache gathers its batches.

Weights: the reference model's state dict (reference/models.py), made in a
few large draws on the device.  Conv, transposed-conv and linear weights
are a normal clipped at 2 standard deviations, scaled to a variance of
1/fan_in (lecun-normal, as the program's trainer initializes);
their biases are 0.  BatchNorm scales and running variances are 1 + u,
shifts and running means u, u uniform in [-0.1, 0.1): not the trainer's
start, so that an eval forward reads every statistic.  The same dict goes
to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

CHUNK = 512  # images drawn at once
# the standard deviation of a unit normal clipped to [-2, 2]
_INNER = math.erf(2 / math.sqrt(2))
CLIPPED_STD = math.sqrt(_INNER - 4 * math.exp(-2) / math.sqrt(2 * math.pi) + 4 * (1 - _INNER))


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one purpose of a run (any whole-number seed)."""
    return int(np.random.SeedSequence([seed % (1 << 128), *stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, *stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *stream))


def labels_by_ratio(gen: torch.Generator, n: int, class_counts: Sequence[int]) -> torch.Tensor:
    """n labels drawn with the probabilities of `class_counts`."""
    p = torch.tensor(class_counts, dtype=torch.float64)
    edges = (p.cumsum(0) / p.sum())[:-1].to(torch.float32).to(gen.device)
    u = torch.rand(n, generator=gen, device=gen.device)
    return torch.bucketize(u, edges, right=True).to(torch.int32)


def classification_images(gen: torch.Generator, labels: torch.Tensor, size: int,
                          num_classes: int) -> torch.Tensor:
    """uint8 [n, size, size, 3] blobs on the generator's device."""
    out = torch.empty((labels.shape[0], size, size, 3), dtype=torch.uint8, device=gen.device)
    step = 200 // max(1, num_classes - 1)
    for s in range(0, labels.shape[0], CHUNK):
        lab = labels[s:s + CHUNK]
        noise = torch.randint(0, 40, (lab.shape[0], size, size, 3), generator=gen,
                              device=gen.device, dtype=torch.int16)
        base = (lab.to(torch.int16) * step + 20)[:, None, None, None]
        out[s:s + CHUNK] = (base + noise).clamp(max=255).to(torch.uint8)
    return out


def segmentation_images(gen: torch.Generator, n: int, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint8 images [n, size, size, 3], uint8 masks [n, size, size])."""
    dev = gen.device
    images = torch.empty((n, size, size, 3), dtype=torch.uint8, device=dev)
    masks = torch.empty((n, size, size), dtype=torch.uint8, device=dev)
    side = size // 2
    ar = torch.arange(size, device=dev)
    for s in range(0, n, CHUNK):
        m = min(CHUNK, n - s)
        noise = torch.randint(0, 60, (m, size, size, 3), generator=gen, device=dev,
                              dtype=torch.uint8)
        y, x = torch.randint(0, size - side, (2, m), generator=gen, device=dev)
        v = torch.randint(180, 255, (m,), generator=gen, device=dev, dtype=torch.uint8)
        rows = (ar >= y[:, None]) & (ar < y[:, None] + side)
        cols = (ar >= x[:, None]) & (ar < x[:, None] + side)
        sq = rows[:, :, None] & cols[:, None, :]
        images[s:s + m] = torch.where(sq[..., None], v[:, None, None, None], noise)
        masks[s:s + m] = sq.to(torch.uint8) * 255
    return images, masks


def device_dataset(task: str, n: int, size: int, class_counts: Sequence[int], seed: int,
                   device, stream: int) -> Dict[str, torch.Tensor]:
    """A split as uint8 tensors on `device`: images, labels (int32) and, for
    segmentation, masks (labels then all 0)."""
    gen = generator(device, seed, stream)
    if task == "classification":
        labels = labels_by_ratio(gen, n, class_counts)
        return {"images": classification_images(gen, labels, size, len(class_counts)),
                "labels": labels}
    images, masks = segmentation_images(gen, n, size)
    return {"images": images, "labels": torch.zeros(n, dtype=torch.int32, device=device),
            "masks": masks}


def dataset(task: str, n: int, size: int, class_counts: Sequence[int], seed: int,
            device, stream: int) -> Dict[str, np.ndarray]:
    """`device_dataset`'s split as host arrays."""
    return {k: v.cpu().numpy()
            for k, v in device_dataset(task, n, size, class_counts, seed, device, stream).items()}


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):  # [in, out, kh, kw]
        return w.shape[0] * w.shape[2] * w.shape[3]
    return w[0].numel()


@torch.no_grad()
def weights(meta_model: nn.Module, seed: int, device, stream: int = 1
            ) -> Dict[str, torch.Tensor]:
    """The float32 state dict of `meta_model` (built on the meta device)
    drawn from the seed on `device`."""
    gen = generator(device, seed, stream)
    dense, bn, zero = [], [], []
    for mname, m in meta_model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            dense.append((pre + "weight", tuple(m.weight.shape), _fan_in(m)))
            if m.bias is not None:
                zero.append((pre + "bias", tuple(m.bias.shape)))
        elif isinstance(m, nn.BatchNorm2d):
            for name, one in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                              ("running_var", 1.0)):
                bn.append((pre + name, (m.num_features,), one))
            zero.append((pre + "num_batches_tracked", ()))
    out: Dict[str, torch.Tensor] = {}
    n_dense = sum(int(np.prod(s)) for _, s, _ in dense)
    flat = torch.randn(n_dense, generator=gen, device=device).clamp_(-2.0, 2.0)
    for (name, shape, fan_in), part in zip(dense, flat.split([int(np.prod(s)) for _, s, _ in dense])):
        out[name] = part.view(shape).mul_(1.0 / math.sqrt(fan_in) / CLIPPED_STD)
    n_bn = sum(s[0] for _, s, _ in bn)
    u = torch.rand(n_bn, generator=gen, device=device).sub_(0.5).mul_(0.2)
    for (name, shape, one), part in zip(bn, u.split([s[0] for _, s, _ in bn])):
        out[name] = part.add_(one)
    for name, shape in zero:
        out[name] = torch.zeros(shape, device=device,
                                dtype=torch.int64 if name.endswith("tracked") else torch.float32)
    missing = set(meta_model.state_dict()) - set(out)
    if missing:
        raise ValueError(f"no rule for the weights {sorted(missing)[:5]}")
    return out

