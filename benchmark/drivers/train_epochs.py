"""Driver `train_epochs`: a recipe's training epochs, epoch after epoch.

The program's path is the one `medseg train <model> --scan-chunk K` takes
(medseg_tpu_torch/train/trainer.py): the CLI's loaders (the packed split on
the device, the trainer's 80/20 split, shuffled epochs), the model from
the registry in the recipe's compute dtype, the recipe's trainable set and
optimizer (global-norm clip + AdamW), and one train step body composed as
`train_model` composes it (the augmentation as its prep, the loss and the
correct count added into device accumulators), driven through
`steps.train_epoch` with `steps.scan_drive`: each epoch captures its CUDA
graph of K steps anew after one eager step, replays it chunk by chunk,
and runs the remainder and the ragged tail per step.  The window reads the
accumulators once an epoch, as the trainer does; it leaves out the
trainer's validation pass and checkpoints.

Set-up: the split made from the seed on the device and handed to the
loader as its device cache (the tensors `BatchLoader._cached` would copy
there from the packed host arrays; the split never crosses to the host),
the weights made from the seed, the model built on the device, the
optimizer and drive built once; then the first steps
of that same object through the window's own call and feed, one short
epoch of (1 + K) batches and the window's ragged tail: the eager first
step, the first captured chunk and the tail's shape.  Their loss, first
gradient and parameter change are read then and compared with the
reference (reference/steps.py) after the window, once the program's state
is freed.  The window then trains whole epochs until --seconds have
passed; `train_img_per_s` is the images of all its epochs over all its
time, capture, remainders and tails included.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from benchmark.harness import data as D
from benchmark.harness import manifest, runner, trace
from benchmark.harness.trace import span

_DATA, _WEIGHTS, _STEP, _ORDER = 0, 1, 2, 3  # sub-seed streams


def _lr(recipe: dict, epoch: int) -> float:
    """The recipe's epoch learning rate: stage 2's plateau rate (no
    validation reads here, so it stays) or the seg recipe's cosine."""
    from medseg_tpu_torch.train.schedules import cosine_annealing

    if recipe["schedule"] == "cosine":
        return cosine_annealing(recipe["lr"], (epoch - 1) % recipe["epochs"], recipe["epochs"])
    return recipe["lr"]


def _moment(opt, p) -> float:
    """The norm of AdamW's first moment of p (0 where it has none)."""
    m = opt.state.get(p, {}).get("exp_avg")
    return 0.0 if m is None else float(torch.linalg.vector_norm(m))


class Trainer:
    """The program's training object and the window's loop over it."""

    def __init__(self, cell, seed: int, device: torch.device, group=None, log=None):
        from medseg_tpu_torch.core.config import AugmentConfig
        from medseg_tpu_torch.core.registry import get_model
        from medseg_tpu_torch.data.loader import BatchLoader, mesh_loaders, split_train_val
        from medseg_tpu_torch.data.packed import PackedDataset
        from medseg_tpu_torch.ops.augment import augment_batch
        from medseg_tpu_torch.parallel.sharding import replicate_
        from medseg_tpu_torch.train import steps as S
        from medseg_tpu_torch.train.freeze import all_trainable, finetune_filter, set_trainable

        self.cell, self.seed, self.device, self.group = cell, seed, device, group
        cfg, tr = cell.config, cell.traffic
        arch, recipe, assumed = cfg["architecture"], cfg["recipe"], cfg["assumed"]
        self.seg = cfg["task"] == "segmentation"
        self.rows = 1 if group is None else group.size
        self.batch = tr["batch_per_chip"] * self.rows  # global
        self.k = tr["scan_chunk"]
        mark = log.mark if log is not None else (lambda name: None)
        mark("imports")
        with span("data"):
            self.arrays = D.device_dataset(cfg["task"], assumed["train_split"],
                                           arch["image_size"], assumed["class_counts"], seed,
                                           device, _DATA)
        mark("data")
        ds = PackedDataset(self.arrays["images"], self.arrays["labels"], self.arrays.get("masks"))
        self.train_idx, _ = split_train_val(len(ds), assumed["val_fraction"])
        order_seed = D.sub_seed(seed, _ORDER)
        loader = BatchLoader(ds, self.batch, shuffle=True, seed=order_seed,
                             indices=self.train_idx, device_cache=True, device=device)
        if group is not None:
            loader, _ = mesh_loaders(group, loader, loader)
        if not loader.device_cache:
            raise ValueError("the split does not fit the loader's device cache")
        loader._dev = (ds.images, loader._target())  # what the first epoch would cache
        self.loader = loader
        self.weights = D.weights(manifest.reference(cfg).build(cfg, "meta"), seed, device,
                                 _WEIGHTS)
        mark("weights")
        dtype = getattr(torch, recipe["compute_dtype"])
        with torch.device(device):  # the factory's own initialization runs on the device
            model = get_model(cfg["model"])["factory"](dtype=dtype, device=device)
        model.load_state_dict(self.weights, strict=True)
        mark("model")
        if group is not None:
            replicate_(model, group)
        rule = finetune_filter(cfg["model"]) if self.seg else all_trainable
        self.trainable = set_trainable(model, rule)
        self.model = model
        self.opt = S.build_optimizer(recipe["lr"], recipe["weight_decay"], recipe["clip_norm"],
                                     self.trainable)
        self.gen_seed = D.sub_seed(seed, _STEP)
        self.gen = torch.Generator(device=device).manual_seed(self.gen_seed)
        self.loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        self.corr_acc = torch.zeros((), dtype=torch.int64, device=device)
        aug_cfg = AugmentConfig()
        seg, gen, opt, ls, rows = self.seg, self.gen, self.opt, recipe["label_smoothing"], self.rows

        # trainer.py's train_prep and train_step, as train_model composes them
        def train_prep(g, images, targets):
            if seg:
                return augment_batch(g, images, targets, cfg=aug_cfg, out_dtype=dtype)
            x, _ = augment_batch(g, images, cfg=aug_cfg, out_dtype=dtype)
            return x, targets

        def train_step(images, targets):
            if seg:
                loss = S.seg_train_step(model, opt, images, targets, gen, prep=train_prep)
            else:
                loss, corr = S.cls_train_step(model, opt, images, targets, gen, ls,
                                              prep=train_prep)
                self.corr_acc.add_(corr)
            self.loss_acc.add_(loss * (images.shape[0] * rows))

        self.S = S
        self.step = train_step
        self.drive = S.scan_drive(loader, self.k, train_step, device, [gen], group,
                                  log=lambda s: None)
        if self.drive is None:
            raise ValueError(f"scan_chunk={self.k} gave no drive: the cell runs on the graph")
        mark("optimizer, drive")

    def _epoch(self, on_chunk) -> None:
        from medseg_tpu_torch.parallel.sharding import data_parallel

        with data_parallel(self.group):
            self.S.train_epoch(self.loader, self.drive, self.device, on_chunk, self.step)

    def first_steps(self) -> dict:
        """Run the first steps: one epoch of (1 + K) global batches of rows
        drawn from the seed, and the window's ragged tail (none under a
        group, whose train batches drop it).  Returns the readings of the
        steps up to and including the first K-step call, and their rows."""
        n_train = len(self.train_idx)
        tail = 0 if self.group is not None else n_train % self.batch
        rng = np.random.default_rng(D.sub_seed(self.seed, _ORDER, 1))
        first = rng.permutation(self.train_idx)[:(1 + self.k) * self.batch + tail]
        trainable = dict((n, p) for n, p in self.model.named_parameters() if p.requires_grad)
        start = {n: p.detach().clone() for n, p in trainable.items()}
        groups, losses, grad, change = [], [], None, None
        b1 = self.opt.param_groups[0]["betas"][0]

        def on_chunk(n, b):
            nonlocal grad, change
            if change is not None:
                return  # past the first chunk: the remainder and the tail
            before = sum(l * g for l, g in zip(losses, groups)) * self.batch
            groups.append(n)
            losses.append((float(self.loss_acc) - before) / (n * self.batch))
            if grad is None:  # AdamW's first moment after the first call's steps
                grad = {k: _moment(self.opt, p) / (1 - b1) for k, p in trainable.items()}
            if n == self.k:  # the parameters as the next step finds them
                change = {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
                          for k, p in trainable.items()}

        self.model.train()
        self.loss_acc.zero_()
        self.S.set_learning_rate(self.opt, _lr(self.cell.config["recipe"], 1))
        self.loader.indices, self.loader.shuffle = first, False
        try:
            self._epoch(on_chunk)
        finally:
            self.loader.indices, self.loader.shuffle = self.train_idx, True
        if change is None:
            raise RuntimeError(f"the first steps ran as {groups}: no {self.k}-step chunk")
        return {"loss": losses, "grad": grad, "change": change, "groups": groups,
                "rows": first[:sum(groups) * self.batch]}

    def window(self, seconds: float, stop_all=None) -> dict:
        """Whole epochs until `seconds` have passed (on any rank, with
        `stop_all`); what they did, on the host clock."""
        recipe = self.cell.config["recipe"]
        done = {"images": 0, "steps": 0}

        def on_chunk(n, b):
            done["steps"] += n
            done["images"] += n * b * self.rows

        captures, epochs = [], 0
        t0 = time.perf_counter()
        while True:
            epochs += 1
            self.S.set_learning_rate(self.opt, _lr(recipe, epochs))
            self.model.train()
            self.loss_acc.zero_()
            self.corr_acc.zero_()
            before = self.drive.captures
            with span("epoch"):
                self._epoch(on_chunk)
            with span("epoch-end read"):
                float(self.loss_acc)  # the trainer's read of an epoch's statistics
            if self.device.type == "cuda" and self.drive.captures != before + 1:
                raise RuntimeError("an epoch did not capture its graph once")
            captures.append(self.drive.capture_s)
            elapsed = time.perf_counter() - t0
            stop = elapsed >= seconds
            if stop_all is not None:
                stop = stop_all(stop)
            if stop:
                break
        return dict(done, epochs=epochs, window_s=elapsed, capture_s=sum(captures))

    def counters(self, done: dict) -> dict:
        cfg = self.cell.config
        arch = cfg["architecture"]
        c = 4 if self.seg else 3
        dtype = getattr(torch, cfg["recipe"]["compute_dtype"])
        out_bytes = 4 if self.seg else torch.finfo(dtype).bits // 8  # seg's B1 writes float32
        return dict(done, chips=self.cell.chips, b1_rows=done["images"] // self.rows,
                    b1_shape=[arch["image_size"], arch["image_size"], c, out_bytes])

    def free(self) -> None:
        del self.model, self.opt, self.drive, self.loader, self.step
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def batches(cell, rows, arrays, device):
    """The global batches of `rows` as the loader reads them (each sorted),
    with their labels or masks, on `device`."""
    batch = cell.traffic["batch_per_chip"] * cell.chips
    target = arrays["masks"] if cell.config["task"] == "segmentation" else arrays["labels"]
    out = []
    for s in range(0, len(rows), batch):
        idx = torch.from_numpy(np.sort(rows[s:s + batch])).to(target.device)
        out.append((arrays["images"][idx].to(device), target[idx].to(device)))
    return out


def check(cell, readings: dict, weights, arrays, gen_seed, device,
          precision: str = "float32", worst: dict = None) -> dict:
    """The numbers compared: the reference follows the program's first
    steps on their global batches."""
    from benchmark.harness import compare
    from benchmark.reference import steps as ref

    r = ref.follow(cell.config, weights, batches(cell, readings["rows"], arrays, device),
                   gen_seed, readings["groups"], _lr(cell.config["recipe"], 1), precision)
    if worst is not None:  # the three leaves that read farthest, for the look
        for key, keep in (("grad", None), ("change", compare.moving_leaves(r["grad"]))):
            gaps = compare.leaf_gaps(readings[key], r[key], keep)
            worst[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        worst["loss"] = [readings["loss"], r["loss"]]
    return compare.train_numbers(readings, r, cell.config["recipe"].get("head_leaves", ()))


def measure(cell, seed: int, seconds: float, trace_on: bool, device, group=None,
            stop_all=None, t_start: Optional[float] = None):
    """Set-up, window and check of one process (one rank under `group`);
    the check runs on rank 0 only."""
    log = runner.SetupLog(t_start if t_start is not None else time.time())
    t = Trainer(cell, seed, device, group, log)
    readings = t.first_steps()
    log.mark("first steps")
    if group is None or group.rank == 0:
        log.print()
    window = cell.traffic["trace_seconds"] if trace_on else seconds
    session = trace.Session(device, enabled=trace_on)
    setup_s = time.time() - t_start if t_start is not None else None
    with session:
        done = t.window(window, stop_all)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counters = t.counters(done)
    counters["setup_s"] = setup_s
    weights, arrays, gen_seed = t.weights, t.arrays, t.gen_seed
    t.free()
    numbers = {}
    if group is None or group.rank == 0:
        numbers = check(cell, readings, weights, arrays, gen_seed, device)
    e2e = {"train_img_per_s": done["images"] / done["window_s"]}
    if setup_s is not None:
        e2e["setup_s"] = setup_s
    return runner.Outcome(e2e=e2e, counters=counters, numbers=numbers,
                          attempted=done["steps"], failed=0, memory_peak_bytes=peak,
                          session=session if trace_on else None)


def run(cell, seed: int, seconds: float, trace_on: bool, device, t_start: float) -> dict:
    out = measure(cell, seed, seconds, trace_on, device, t_start=t_start)
    return runner.finish(cell, out, trace_on, device)
