"""The optimizer stack and the train and eval steps.

Counterpart of medseg_tpu/train/steps.py:32-56 (optimizer), :68-95 and
:111-141 (classification and segmentation train steps) and :274-313 (the
eval steps).  The optimizer holds only the trainable parameters
(train/freeze.py); its step clips their gradients by global norm as
optax's clip_by_global_norm does, then applies AdamW.  The learning rate
lives in the param groups and is set per epoch from the host.

No step reads a value back to the host: the clip decides with
`torch.where` on the card, and losses, correct counts and IoUs are
returned as device tensors for the caller to accumulate.  In bf16 the parameters stay
float32 and the convs cast them per forward (nn/blocks.py), so gradients
reach them through the cast, as with flax's `dtype`: no autocast, no loss
scaling.

Under data parallelism (parallel.data_parallel, the JAX steps jitted over
a sharded batch) a train step averages the gradients over the group in one
flattened all-reduce, together with the loss and the correct count, before
the clip and AdamW: clipping each rank's own gradients first would give
another update.  The eval steps return the group's loss sums, correct
counts and IoU.

`scan_epoch` and `scan_epoch_driver` (medseg_tpu/train/steps.py:152-271)
run K train steps per dispatched program: on the card one CUDA graph of
K steps, replayed once per chunk of the epoch (ScanDrive); on the CPU the
same eager step K times.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from medseg_tpu_torch.parallel.sharding import (DataParallelGroup, all_reduce_sum,
                                                current_group)
from medseg_tpu_torch.train import losses

Prep = Callable[[torch.Generator, torch.Tensor, torch.Tensor],
                Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g * (max_norm / |g|) where the
    global norm |g| >= max_norm, g unchanged below it (no epsilon, unlike
    clip_grad_norm_).  Returns the norm before clipping, on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class ClippedAdamW(torch.optim.AdamW):
    """AdamW whose step first clips the gradients of its parameters by
    global norm (optax.chain(clip_by_global_norm, adamw)).

    On the card it is fused (one multi-tensor kernel per step) and
    capturable, so a CUDA graph can hold its step (ScanDrive): the fused
    kernel's arithmetic is the same either way.  load_state_dict keeps this
    optimizer's own `fused` and `capturable` and moves the step counts to
    the parameters' device: a resume file written on the other device, or
    before the optimizer was capturable, carries others."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float,
                 weight_decay: float, clip_norm: float):
        params = list(params)
        on_card = params[0].is_cuda
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay, fused=on_card or None,
                         capturable=on_card)
        self.clip_norm = clip_norm

    def load_state_dict(self, state_dict) -> None:
        own = [(g["fused"], g["capturable"]) for g in self.param_groups]
        super().load_state_dict(state_dict)
        for g, (fused, capturable) in zip(self.param_groups, own):
            g["fused"], g["capturable"] = fused, capturable
            for p in g["params"]:
                st = self.state.get(p)
                if st and (fused or capturable):
                    st["step"] = st["step"].to(device=p.device, dtype=torch.float32)

    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups for p in group["params"]
                 if p.grad is not None]
        clip_by_global_norm_(grads, self.clip_norm)
        return super().step(closure)


def build_optimizer(lr: float, weight_decay: float, clip_norm: float,
                    trainable: Iterable[nn.Parameter]) -> ClippedAdamW:
    """Global-norm clip + AdamW(betas 0.9/0.999, eps 1e-8) over `trainable`
    only: frozen parameters are absent, so they get no update, no weight
    decay and no share of the norm."""
    return ClippedAdamW(trainable, lr, weight_decay, clip_norm)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


@torch.no_grad()
def all_reduce_step_(optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                     *counts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Under a joined data-parallel group: one all-reduce of the gradients
    of `optimizer`'s parameters, the loss and `counts`, flattened into one
    bucket; the gradients (in place) and the loss come back averaged over
    the ranks, the counts summed.  Otherwise (loss, *counts) as given."""
    group = current_group()
    if group is None or not group.joined:
        return (loss, *counts)
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    dt = grads[0].dtype
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [t.reshape(1).to(dt) for t in (loss, *counts)])
    group.all_reduce_(flat)
    parts = torch.split(flat, [g.numel() for g in grads] + [1] * (1 + len(counts)))
    for g, v in zip(grads, parts):
        g.copy_(v.view_as(g))
    torch._foreach_mul_(grads, 1.0 / group.size)
    loss = (parts[len(grads)] / group.size).reshape(()).to(loss.dtype)
    return (loss, *(v.round().reshape(()).to(c.dtype)
                    for v, c in zip(parts[len(grads) + 1:], counts)))


def cls_train_step(model: nn.Module, optimizer: ClippedAdamW,
                   images: torch.Tensor, labels: torch.Tensor,
                   gen: torch.Generator, label_smoothing: float = 0.1,
                   prep: Optional[Prep] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: prep (the augmentation, drawing from `gen`) -> train-mode
    forward (dropout drawing from `gen`) -> label-smoothed CE -> backward
    -> clip + AdamW.  The model is in training mode.  Returns (loss,
    correct) as device scalars; the clipped gradients stay in .grad."""
    if prep is not None:
        images, labels = prep(gen, images, labels)
    out = model(images, generator=gen)
    loss = losses.cross_entropy(out, labels, label_smoothing)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss, correct = all_reduce_step_(optimizer, loss.detach(),
                                     (out.detach().argmax(-1) == labels).sum())
    optimizer.step()
    return loss, correct


@torch.no_grad()
def cls_eval_step(model: nn.Module, images: torch.Tensor, labels: torch.Tensor,
                  n_valid: int, label_smoothing: float = 0.1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss_sum, correct, preds) over the first n_valid rows: pad rows
    (repeats of the last sample, loader pad_to_multiple) add nothing.  The
    model is in eval mode."""
    out = model(images)
    valid = losses.valid_mask(images.shape[0], n_valid, out.device)
    loss_sum = (losses.per_sample_cross_entropy(out, labels, label_smoothing)
                * valid).sum()
    preds = out.argmax(-1)
    correct = ((preds == labels) & (valid > 0)).sum()
    if current_group() is not None:  # the group's sums; preds stay this rank's
        loss_sum, total = all_reduce_sum(torch.stack([loss_sum, correct.to(loss_sum.dtype)]))
        correct = total.round().to(correct.dtype)
    return loss_sum, correct, preds


def seg_train_step(model: nn.Module, optimizer: ClippedAdamW,
                   images: torch.Tensor, masks: torch.Tensor,
                   gen: torch.Generator, prep: Optional[Prep] = None) -> torch.Tensor:
    """One step: prep (the augmentation with the mask, drawing from `gen`)
    -> train-mode forward -> BCE with logits -> backward -> clip + AdamW.
    The model is in training mode, so every BatchNorm, a frozen encoder's
    too, normalizes with batch statistics and updates its running ones, as
    flax's mutable batch_stats do whatever the optimizer's mask says.
    Frozen parameters (requires_grad False) get no gradient and are not in
    the optimizer.  Returns the loss as a device scalar."""
    if prep is not None:
        images, masks = prep(gen, images, masks)
    loss = losses.bce_with_logits(model(images), masks)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss, = all_reduce_step_(optimizer, loss.detach())
    optimizer.step()
    return loss


@torch.no_grad()
def seg_eval_step(model: nn.Module, images: torch.Tensor, masks: torch.Tensor,
                  n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_sum, batch IoU) over the first n_valid rows: the masked mean
    BCE times max(n_valid, 1), and the masked batch IoU of sigmoid(logits)
    at 0.5 (both the group's under data parallelism).  The model is in
    eval mode."""
    out = model(images)
    valid = losses.valid_mask(images.shape[0], n_valid, out.device)
    loss = losses.masked_bce_with_logits(out, masks, valid)
    iou = losses.masked_batch_iou(torch.sigmoid(out), masks, valid)
    return all_reduce_sum(loss * max(n_valid, 1)), iou


Body = Callable[[torch.Tensor, torch.Tensor], None]


class ScanDrive:
    """K train steps of `body` per call over a device-cached dataset: the
    port's `scan_epoch` (medseg_tpu/train/steps.py:152-230).  Build it with
    scan_epoch().

    body(images, targets) runs one ordinary train step on a gathered batch
    and adds what the caller keeps of it (the loss, a correct count) into
    the caller's own device tensors in place, as the per-step loop does, so
    a chunk sums in that loop's order (JAX's scan stacks the outputs and
    sums them after).

    On the card the first call after a reset captures K calls of body into
    one CUDA graph, each gathering its batch with index_select from a
    static [K, B] index buffer (as the loader's device cache does); every
    call copies its chunk's indices into that buffer (one device-to-device
    copy) and replays the graph: one host call for the K steps' launches,
    and no synchronization.  The graph reads the parameters, buffers and
    gradients, the optimizer's state, the caller's accumulators and the
    dataset cache in place, and keeps every Python value the steps used,
    the learning rate among them: reset() before any of it is replaced (a
    new optimizer, a resume, another learning rate), and the next call
    captures anew into the same memory pool (the old graph is kept until
    then: a pool must have a live graph to be shared, and memory a capture
    left allocated there, such as cuBLAS's workspace for the capture
    stream, stays in it).  `generators` are registered
    with each graph, so a replay draws on from where each stands, as K
    eager steps would.  A capture follows warmup_steps() eager steps of
    the same state (the optimizer's lazily made state, cuBLAS's and
    cuDNN's handles, a kernel's first-call setup); one that fails raises,
    and nothing runs eagerly in its place.  On the CPU each call runs
    body K times eagerly: the graph's plain version.

    Launch counts (the kernel wrappers' `launches`, COLLECTIVE_COUNTS)
    rise while a capture records a launch, once, and not at the replays
    that run it: count a graphed run's launches from the profiler's device
    records."""

    def __init__(self, body: Body, scan_chunk: int, device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        self.body = body
        self.scan_chunk = scan_chunk
        self.device = device
        self.generators = tuple(generators)
        self.graph = None
        self._stale = None  # the graph before a reset, until the next capture
        self.pool = None  # one memory pool for every capture
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0  # the last capture's host seconds, instantiation included
        self._idx = None

    def warmup_steps(self) -> int:
        """Eager steps the caller runs before the next call: 1 on the card
        before a capture, else 0."""
        return int(self.device.type == "cuda" and self.graph is None)

    def reset(self) -> None:
        """The next call captures anew."""
        if self.graph is not None:
            self._stale, self.graph = self.graph, None

    def __call__(self, images_all: torch.Tensor, targets_all: torch.Tensor,
                 idx: torch.Tensor) -> None:
        """Run the K steps of idx ([K, B] int64 on the drive's device) on the
        rows of images_all and targets_all: the tensors the graph was
        captured on, until a reset."""
        if idx.shape[0] != self.scan_chunk:
            raise ValueError(f"a chunk of {idx.shape[0]} steps, not {self.scan_chunk}")
        if self.device.type != "cuda":
            for row in idx:
                self.body(images_all.index_select(0, row), targets_all.index_select(0, row))
            return
        if self.graph is None:
            self._capture(images_all, targets_all, idx)
        self._replay(idx)

    def _replay(self, idx: torch.Tensor) -> None:
        self._idx.copy_(idx)
        self.graph.replay()
        self.replays += 1

    def _capture(self, images_all, targets_all, idx) -> None:
        self._idx = torch.empty_like(idx)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.pool):
            for row in self._idx:
                self.body(images_all.index_select(0, row), targets_all.index_select(0, row))
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        self.captures += 1
        if self._stale is not None:  # the capture synchronized: its replays have run
            self._stale.reset()
            self._stale = None


def scan_epoch(body: Body, scan_chunk: int, device, generators: Sequence[torch.Generator] = (),
               group: Optional[DataParallelGroup] = None) -> ScanDrive:
    """The ScanDrive of K = scan_chunk > 1 steps of `body` on `device`.
    Under a joined data-parallel `group` on the card the collectives go
    into the graph, which NCCL's can and gloo's cannot: any other backend
    there raises."""
    if scan_chunk < 2:
        raise ValueError(f"scan_chunk must be at least 2, got {scan_chunk}")
    device = torch.device(device)
    if device.type == "cuda" and group is not None and group.joined:
        backend = dist.get_backend(group.process_group)
        if backend != "nccl":
            raise ValueError(
                f"scan_chunk={scan_chunk} under a {backend} group on the card: a CUDA "
                f"graph captures NCCL's collectives, not {backend}'s; join with NCCL "
                f"or train without scan_chunk")
    return ScanDrive(body, scan_chunk, device, generators)


def scan_drive(loader, scan_chunk: int, body: Body, device, generators=(), group=None,
               log: Callable[[str], None] = print) -> Optional[ScanDrive]:
    """A recipe's ScanDrive, or None for the per-step loop: scan_chunk of 0
    or 1, or a loader without its device cache (logged with the JAX
    trainer's line, medseg_tpu/train/trainer.py:225-228)."""
    if scan_chunk <= 1:
        return None
    if not loader.device_cache:
        log(f"[scan_chunk] disabled: requires device_cache "
            f"(device_cache={loader.device_cache})")
        return None
    return scan_epoch(body, scan_chunk, device, generators, group)


def _on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host index array on `device` without a synchronization (through
    pinned memory on the card)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def scan_epoch_driver(loader, drive, on_chunk: Callable[[int, int], None],
                      on_step: Callable[[torch.Tensor, torch.Tensor], None]) -> None:
    """One epoch of `loader` through `drive`: the one owner of the chunk /
    remainder / tail routing (medseg_tpu/train/steps.py:233-271).  Whole
    [K, B] chunks of the epoch's full batches run in `drive`, and
    on_chunk(K, B) follows each; remainder full batches and the ragged
    tail go to on_step(images, targets), the ordinary per-step path, so no
    second, differently shaped graph is captured.  On the card the
    drive's warm-up steps go to on_step first, and the chunks start after
    them.  loader.epoch_index_batches consumes the shuffle exactly like
    one __iter__ pass, so the epoch is the per-step epoch re-chunked: the
    same batches in the same order, the same draws, the same updates.
    The indices go to the device once an epoch."""
    idx_full, idx_tail = loader.epoch_index_batches()
    dev, k = drive.device, drive.scan_chunk
    images_d, target_d = (t.to(dev) for t in loader._cached())
    rows = _on(idx_full, dev)

    def one(row):
        on_step(images_d.index_select(0, row), target_d.index_select(0, row))

    warm = min(drive.warmup_steps(), len(idx_full))
    n_scan = warm + (len(idx_full) - warm) // k * k
    for i in range(warm):
        one(rows[i])
    for s in range(warm, n_scan, k):
        drive(images_d, target_d, rows[s:s + k])
        on_chunk(k, rows.shape[1])
    for i in range(n_scan, len(idx_full)):
        one(rows[i])
    if idx_tail is not None:
        one(_on(idx_tail, dev))


def train_epoch(loader, drive: Optional[ScanDrive], device,
                on_chunk: Callable[[int, int], None],
                on_step: Callable[[torch.Tensor, torch.Tensor], None]) -> None:
    """One epoch of a recipe's train steps: on_step(images, targets) per
    batch of the loader (moved to `device`) without a drive, else through
    scan_epoch_driver with the graph captured anew, since a new epoch
    brings a new learning rate and may bring a new optimizer or state.
    on_chunk(n, b) follows every n steps of b rows, a lone step's too."""
    def step(images, targets):
        on_step(images, targets)
        on_chunk(1, images.shape[0])

    if drive is None:
        for images, targets in loader:
            step(images.to(device), targets.to(device))
        return
    drive.reset()
    scan_epoch_driver(loader, drive, on_chunk, step)
