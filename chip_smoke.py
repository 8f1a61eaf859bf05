#!/usr/bin/env python3
"""Smoke run of the PyTorch port (medseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It
1. prints the card (torch's name, and nvidia-smi's name and power limit);
2. builds every CUDA kernel of the port from medseg_tpu_torch/csrc/, one
   nvcc each, all started together;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes its paths give it, with the tolerance stated per case, and times
   kernel, plain version and, where there is one, a library call, as device
   time from torch.profiler (the kernel's own launches only, for the
   kernel; the median of three sessions, or of five when the three
   spread); the zoo path's forms (B1 at C=3 bf16 B=16, B2's eval form
   f32 at 224^2 for B=1 and 8 and bf16 at B=16, 256^2) and the clip
   path's (B2's eval form f32 with CLIP's mean and std at 224^2 and 352^2
   for B=1 and 8) at tolerance 0, timed beside their bounds and
   `x.to(dtype)` of the same bytes;
4. drives eleven paths at full width, each with every launch count set to
   0 just before it and read just after (ingest right after the first
   three; clip, finetune and dp before zoo: late in a run profiler sessions
   lose records, and the zoo's readings tolerate it).  The CPU halves of
   the seg and zoo paths' gate 4 (the float32 and float64 CPU runs and the
   comparisons) run in one spawned CPU worker while the card works; it is
   stopped while a host-clock reading is taken, and drained at the end of
   the zoo path:
   - aug+infer: a synthetic packed set at 256px, BatchLoader(device_cache=
     True), augment_batch (one warp-kernel launch with the photometric
     epilogue) -> ResNet18 bf16 forward -> argmax -> classification_metrics;
     the bf16 forward must agree with a float32 forward of the same weights;
   - eval: a random ResNet18 written as the reference's .pt, then
     test_all_models over a 1000-image synthetic test split (batches of 16,
     one photometric-kernel launch each) -> print_summary ->
     save_results_to_csv, read back with csv; then, on one batch,
     preprocess_eval_batch must run exactly one device operation, and its
     device time and the forward's are printed;
   - fused stem: the warp kernel's planar bf16 output -> apply_with_stem_
     kernel (one stem-kernel launch) on ResNet18 bf16, against model(x) on
     the same batch in NHWC, both timed by device time in turns;
   - ingest: from the dataset's PNGs to the demo through
     medseg_tpu_torch.apps.cli.main in this process: 3 classes x 100
     X-ray-like 299x299 PNGs (masks at 256x256, none for the last 5 of a
     class), `split`, `pack` (the native C++ loader when g++ and libpng
     build it, else cv2), `train ResNet18 ResNetUnet --epochs 2 --profile
     DIR` at full width, `eval`, `eval --compare` and `parity --reference`
     against copies of its own CSVs and against a copy with one metric
     moved by 1 pp, and `demo --builtin --no-warmup` as a `python -m`
     subprocess.  Gates: the CSVs partition the tree 240/30/30 by class;
     the six caches' shapes, labels and masks; the native loader against
     cv2 (bilinear within 1, the letterbox's pad 0, nearest masks under 1%
     apart, the train split packed both ways) when it built; exactly one B1
     launch a train step and one B2 a validation, eval and parity batch;
     each trace names the warp kernel once a step; the reports read 0.000
     and PASS on the copy, 1.000 and FAIL on the moved one (parity exits 0
     and 1); the demo's page and CSS are the port's and /predict answers a
     class.  Readings: pack img/s by route, each command's wall time;
   - train: train_model("ResNet18") bf16 on a 1280-sample synthetic set at
     256px (1024 to train in 8 shuffled steps of 128 from the device cache,
     256 to validate in 2 batches), 3 epochs with the stage switch after
     epoch 1, saving; then a resume to epoch 4.  Gates: the logs (both
     stages, finite losses, the resume's one epoch), exactly one warp
     launch per train step and one photometric launch per validation
     batch, the best checkpoint loaded strictly and evaluated, 3 float32
     stage-2 steps on the card against the same 3 in float64 on the CPU
     (clipped gradients of step 1, parameters and running statistics after
     step 3, each within twice the CPU float32 run's own distance),
     the bf16 step's loss within 5% of the float32 step's, and 20
     steady-state steps under torch.cuda.set_sync_debug_mode("error").  It
     prints the stage-2 step rate (host clock), the step's device time
     split into augment, forward with loss, backward, and clip + AdamW,
     and its device operations;
   - seg: train_model("ResNetUnet") bf16 at 256px, B=8 (ResNet50 encoder
     frozen, five ConvTranspose decoder stages) on 160 synthetic_seg
     samples (128 to train in 16 shuffled steps from the device cache, 32
     to validate in 4 batches), 3 epochs and a resume to epoch 4.  Gates:
     the logs, exactly one warp launch (the mask as its 4th plane, float32
     out) per step and one photometric launch per validation batch, the
     encoder's parameters bit for bit their initial values while its
     running statistics and the decoder's weights moved, the best
     checkpoint loaded strictly and evaluated by test_all_models (one
     photometric launch per batch of 16) into the segmentation CSV, read
     back; gates 4 and 5 as in train for 3 float32 seg steps; the mask
     gate (the card's fused augmentation against the CPU branch on the
     same AugmentParams: images within 1e-3, masks apart only on region
     edges); 20 steps without a synchronization.  Readings: the seg step's
     rate, device split and its ConvTranspose and BatchNorm shares, B1's
     C=4 float32 form at B=8 and 128 beside its bound, and seg_e2e
     (4-plane augment + ResNetUnet bf16 + sigmoid > 0.5 at B=128);
   - serve: ResNet18 and ResNetUnet float32 (init_weights from SEED, random
     BN statistics) written as the reference's .pt under two weights
     roots, the classifier's head biased to COVID in one and to Healthy in
     the other; an InferenceServer on each, warmed up (B=1, 2, 4, 8), over
     loopback.  Requests are PNGs (PIL, as the server) at 299x299 (the
     Kaggle COVID-19 Radiography Database's size), 256x256, 512x384 and
     1024x1024 (W x H).  Gates: (1) exactly 2 photometric launches a group
     when COVID-forced, 1 when Healthy-forced; (2) the same 8 images
     through the port's Pipeline on the card (TF32 off) and on the CPU:
     the same classes, logits within 1e-3*max(1, |logit|max), seg
     probabilities within 1e-3, each differing mask pixel's CPU
     probability within 1e-3 of 0.5, overlays equal where the masks agree;
     (3) a burst of 8 concurrent requests meets no new batch shape in
     either forward's seen_batches and is micro-batched (max_batch >= 2);
     (4) each overlay decodes to its request's H x W x 3 and /health names
     both models; (5) batch_predict over 128 PNGs at 299x299 in batches of
     64: 128 CSV rows, one overlay file per COVID row, 2 photometric
     launches a batch with COVID rows and 1 otherwise.  Readings, under
     PyTorch's default flags (cuDNN TF32 on): p50/p99 of 100 sequential
     single 299x299 requests and their stages by host clock, 10 bursts of
     8, the synchronizations of one group, the device time of one B=8 COVID
     group and its parts beside its host clock, batch_predict's img/s;
   - zoo: for each of VGG16, VGG19 (B=16), AttentionUNet, R2Unet and
     R2AttUnet (B=8), train_model bf16 at 256px on synthetic data, 2
     epochs of 4 steps and 2 validation batches (VGG: the stage switch
     after epoch 1), then a resume to epoch 3.  Gates: finite logged
     losses, exactly one B1 launch per train step and one B2 launch per
     validation batch in each run, the best .pt loaded strictly into a
     fresh model; 10 steady steps under set_sync_debug_mode("error"); 3
     float32 steps on the card against float64 on the CPU as in train, at
     64px, B=2 (float64 R2 steps at 256px are too slow for the CPU) and
     the bf16 loss within 5%.  Readings: the steady step's rate by host
     clock, device time, idle share, device operations, the convs'
     TFLOP/s and peak memory (AttentionUNet's also at the JAX bench's
     B=16).  Then the five .pt through test_all_models (one B2 launch a
     batch of 16 a model) into both CSVs, read back; and an
     InferenceServer with VGG16 + AttentionUNet float32 .pt, COVID-forced:
     serve gate 2 (the card's Pipeline against the CPU's on 8 images), 2
     B2 launches a group, VGG16 on 224 and the U-Net on 256, every overlay
     at its request's size, the same with R2AttUnet as the segmenter, and
     one B=8 group's device time beside its host clock;
   - clip: CLIP (ViT-B/32 at 224, the full 49408-token text tower) and
     CLIPSeg (rd64-refined, ViT-B/16 at 352) float32, init_weights from
     SEED, written as the reference's HF-named .pt (~1.2 GB, removed
     afterwards), CLIP COVID-forced through its image side; prompt ids
     from a JSON bundle of arbitrary ids (MEDSEG_PROMPT_IDS).  Gates:
     test_all_models over a 64-image 256px split with no B2 launch (the
     harness resizes floats), both CSVs read back, the prompt features
     and CLIPSeg's embedding on the card within 1e-5 of the CPU's; servers
     for CLIP + CLIPSeg, ResNet18 + CLIPSeg and CLIP + ResNetUnet, each
     warmed up, with exactly 1 B2 launch a group + 1 per group with a
     COVID prediction (counted from the groups' predictions), no new
     batch shape in a burst, overlays at each request's size; the card's
     CLIP + CLIPSeg Pipeline against the CPU's on 8 images at 299^2,
     512x384 and 1024^2 (bicubic uint8 grids equal but for rounding ties,
     logits within 1e-3*max(1, |logit|max), probabilities within 1e-3).
     Readings: a B=8 forward of each split into GEMMs, SDPA, LayerNorm,
     B2 and the rest with the GEMMs' TFLOP/s, the patch embedding as a
     GEMM beside cuDNN's conv, peak memory, and p50/p99 of 299^2
     requests through CLIP + CLIPSeg with their stages;
   - finetune: the CLI's train half as a user runs it, through
     medseg_tpu_torch.apps.cli.main in this process, on synthetic packed
     caches at 256px with $MEDSEG_PROMPT_IDS unset: `train ResNet18
     ResNetUnet --epochs 6` (the stage switch after epoch 5), `finetune-
     clip --random-init --epochs 2` (ViT-B/32 at 224, B=32, float32),
     `finetune-clipseg --random-init --epochs 2` (rd64-refined at 352,
     B=8; 53 train samples, so each epoch ends in a padded tail of 5),
     `eval`, `predict --cls-model CLIP --seg-model CLIPSeg` (CLIP's aux
     COVID-forced in a copy of the weights, so CLIPSeg serves too), and
     `eval` again as a `python -m` subprocess (exit 0).  Gates: finite
     epoch losses for the four models; exactly one B1 launch per `train`
     step and one B2 per CNN validation and eval batch, none in the
     finetuners, 1 + 1 in `predict`; the four best .pt load strictly,
     CLIP's and CLIPSeg's aux equal the draws they were trained with, and
     against their seeded init (drawn again) every vision_model.* /
     decoder.* tensor moved and every other is bit for bit; both CSVs
     list the four models; no synchronization in 5 steady steps of each
     recipe (and a padded-tail step); 3 float32 steps of each recipe at
     full width (CLIP B=4, CLIPSeg B=2 with its second step the padded
     tail) on the card and CPU within twice the CPU's distance from
     float64 (or the gradients within 1e-4 of float64's own magnitude
     and the parameters within 1e-2 of its update: the CPU's distance
     swings 3-14x between runs) and in float64 on the card within 1e-9 of
     the CPU's (the key biases' zero gradients held apart).  Readings:
     each step's rate by host clock, device split (preprocess, forward
     with loss, backward, clip + AdamW), idle share, device operations,
     GEMM TFLOP/s and peak memory;
   - dp: data parallelism on the one card.  (a) NCCL world 1 in this
     process (MEDSEG_* naming one process): one bf16 step each of ResNet18
     (B=16, stage 2) and ResNetUnet (B=8) launches exactly the all-reduces
     the design implies (one a training BatchNorm's forward, one its
     backward when its input needs a gradient, one gradient bucket; the
     BatchNorms counted by hooks), their device time a step beside the
     step's (a reading); then through cli.main on the finetune path's
     caches `train ResNet18 ResNetUnet --data-parallel --epochs 2` (one B1
     a step, one B2 a validation batch), `eval --data-parallel` against
     `eval` (CSVs within rel 1e-4) and `finetune-clipseg --data-parallel
     --random-init --epochs 1`; and ResNet18's world-1 data-parallel
     float64 step against the plain one within 1e-9.  (b) two ranks on
     cuda:0 under gloo (NCCL refuses two ranks on one GPU), spawned while
     (a) runs: ResNet18 at 256px, global B=32, 3 float32 steps (TF32 off)
     and 3 float64 steps, one float64 ResNetUnet step (frozen encoder
     training its BatchNorms), a save_best and `eval --data-parallel` of a
     13-sample split (ragged tails); each rank exactly 7 B1 and 6 B2.
     Held against one process on the global batch: float64 within 1e-9;
     float32 within the largest distance from float64 of three one-process
     runs on permuted rows, plus their spread; the eval CSVs within rel
     1e-4; only rank 0 wrote.  Readings: the all-reduce share, the path's
     seconds;
5. prints one JSON line with every kernel's launches, error and times, and
   as its last line {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when there is no card, when it is
not run from a checkout, or when any phase fails.  It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
import urllib.request
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 rate
# outside the tensor cores, and dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

BATCH = 128          # main-path batch
SIZE = 256           # IMG_SIZE
N_SAMPLES = 1024     # 8 batches of 128
EVAL_SAMPLES = 1000  # eval path: 62 batches of 16 and a ragged 8
EVAL_BATCH = 16      # EvalConfig.batch_size
TRAIN_SAMPLES = 1024  # train path: 8 steps of 128 an epoch
VAL_SAMPLES = 256     # ... and 2 validation batches of 128
TRAIN_EPOCHS = 3      # stage 1 is epoch 1
RATE_STEPS = 24       # stage-2 steps timed by host clock
SYNC_STEPS = 20       # stage-2 steps under set_sync_debug_mode("error")
PARITY_BATCH = 8      # card against CPU, float32
PARITY_LR = 1e-5      # ... with the stage-2 optimizer at this lr
SEG_BATCH = 8         # seg path: TrainConfig.seg_batch_size
SEG_TRAIN = 128       # ... 16 steps of 8 an epoch
SEG_VAL = 32          # ... and 4 validation batches of 8
SEG_EPOCHS = 3
SEG_PARITY_BATCH = 4  # card against CPU, float32 (the CPU's float64 steps)
SEG_E2E_BATCHES = 4   # seg_e2e reading: batches of BATCH
SERVE_BATCHES = (1, 2, 4, 8)  # serve path: the micro-batch shapes (MAX_BATCH 8)
SERVE_SHAPES = ((299, 299), (256, 256), (384, 512), (1024, 1024))  # (H, W)
SERVE_REQUESTS = 100  # sequential single-image requests timed
SERVE_BURSTS = 10     # bursts of 8 concurrent requests timed
PREDICT_IMAGES = 128  # batch_predict: a directory of 299x299 PNGs
PREDICT_BATCH = 64    # ... in batches of 64 (its default)
ZOO_STEPS = 4         # zoo path: train steps an epoch at the recipe's batch
ZOO_VAL = 2           # ... validation batches an epoch
ZOO_EPOCHS = 2        # ... and a resume to one more (VGG: stage 1 is epoch 1)
ZOO_RATE_STEPS = 8    # ... steady steps timed by host clock
ZOO_SYNC_STEPS = 10   # ... steps under set_sync_debug_mode("error")
ZOO_BIG_SEG_BATCH = 16  # ... AttentionUNet's step also at the JAX bench's B=16
ZOO_PARITY_SIZE = 64  # ... card against CPU at 64px, B=2, full width
ZOO_PARITY_BATCH = 2
SEED = 0
PROFILE_SESSIONS = 3     # device_ms: profiler sessions per reading
PROFILE_MARGIN_S = 0.05  # ... host idle at both ends of each (see _sessions)
# ... whose times may differ by this share of their median (complete
# sessions of one kernel have spread by a few percent)
PROFILE_SPREAD = 0.10
# ... and brackets its calls with two launches of torch.cuda._sleep's kernel
MARKER = "spin_kernel"
MARKER_CYCLES = 1000
EMPTY_SESSION_TAKES = 3  # takes of a session that recorded nothing at all


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class DeviceOp(NamedTuple):
    """One name's device operations in a profiler session, as a row of
    prof.key_averages(): how many, and their device time in microseconds."""
    key: str
    count: int
    device_time_total: float


def _device_ops(prof) -> list:
    """The session's device operations by name, the rows of
    prof.key_averages() whose device type is CUDA, user annotations left out
    (optimizer.step's spans its kernels and the gaps between them on the
    device: not an operation), read from the raw Kineto events.  The same
    names, counts and times as key_averages() (an event's device time is
    its span; an asynchronous one counts but adds no time), without building
    its Python event tree over the session's host operations too: for a
    session of a few training steps that tree took tens of seconds."""
    from torch.autograd import DeviceType

    rows = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or e.is_hidden_event()):
            continue
        row = rows.setdefault(e.name(), [0, 0.0])
        row[0] += 1
        if not (e.is_async() or e.start_thread_id() != e.end_thread_id()):
            row[1] += (e.end_ns() - e.start_ns()) / 1e3
    return [DeviceOp(k, n, t) for k, (n, t) in rows.items()]


def _sessions(fn, reps: int, sessions: int = PROFILE_SESSIONS):
    """`sessions` profiler sessions of `reps` calls of fn(), each after
    two warm-up calls and with PROFILE_MARGIN_S of host idle at both ends:
    without that margin, a session now and then lost the records of
    launches near its ends, reading a kernel low, or gained some of the
    warm-up's; with it, none did.  From the aug+infer path on, every
    session still lost one record (49 of 50 calls, 0 of 1), so the calls
    sit between two marker kernels (MARKER): the record lost is a marker's,
    and no reading counts markers.  A session that records no device
    operation at all, markers included, is taken again (up to
    EMPTY_SESSION_TAKES times): one of the eval path's once lost every
    record.  Yields each session's device events other than the
    markers and user annotations, and says so when a session loses a
    marker."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(sessions):
        for _attempt in range(EMPTY_SESSION_TAKES):
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_MARGIN_S)
                torch.cuda._sleep(MARKER_CYCLES)
                for _ in range(reps):
                    fn()
                torch.cuda._sleep(MARKER_CYCLES)
                torch.cuda.synchronize()
                time.sleep(PROFILE_MARGIN_S)
            events = _device_ops(prof)
            if events:
                break
            print("chip_smoke: a profiler session recorded no device operation, "
                  "its markers included; taking it again")
        markers = sum(e.count for e in events if MARKER in e.key)
        if markers != 2:
            print(f"chip_smoke: a profiler session recorded {markers} of its 2 "
                  f"marker kernels")
        yield [e for e in events if MARKER not in e.key]


def _agreeing(taken, k: int, lost: int, reps: int, complete: bool):
    """The first k of the sessions in `taken` whose operation counts lie
    within `lost` below one count c, or None when no such group holds k.
    The higher counts c are tried first; with `complete`, only those that
    are a multiple of `reps` (a session of reps calls that recorded every
    operation of each)."""
    for c in sorted({t[1] for t in taken}, reverse=True):
        group = [t for t in taken if c - lost <= t[1] <= c]
        if len(group) >= k and (c % reps == 0 or not complete):
            return group[:k]
    return None


def session_times(fn, reps: int, kernel: str = "", what: str = "",
                  lost: int = 0, sessions: int = PROFILE_SESSIONS):
    """Milliseconds of device time per call of fn() in each of `sessions`
    profiler sessions of `reps` calls (see _sessions): the
    kernels whose name contains `kernel` (one launch per call), or every
    kernel and copy that fn() runs.  Host overhead between launches is not
    counted.  Returns (times, the last session's five costliest device
    operations as (ms per call, name)).  Fails if a session records no such
    device time, or if the sessions record different numbers of device
    operations (for a named kernel: other than one per call).  `lost`
    allows a whole fn's sessions that many operations apart: for readings
    that gate nothing, since one of the train step's sessions of 6000
    records now and then loses a record besides a marker's, which moves
    the reading by one kernel's share.  When the counts of a whole fn's
    sessions differ by more, up to `sessions` more sessions are taken,
    one at a time, until `sessions` of all those taken agree (within
    `lost`) on a count that is a multiple of `reps`, or failing that on
    any count; the reading is theirs, and the others are printed: one
    session of B1's plain version at B=128 once recorded 2140 operations
    against 2134 twice, 12 elementwise kernels more, and two of three of
    the serve path's ResNet18 forwards once recorded 393 against 405, a
    forward's max pool, convs and BatchNorms fewer, twice in a row."""
    what = what or kernel or "fn"
    taken = []  # (ms per call, operations, {name: count}, five costliest)

    def take(n):
        for events in _sessions(fn, reps, n):
            events = [e for e in events if kernel in e.key]
            total_us = sum(e.device_time_total for e in events)
            if total_us <= 0:
                fail(f"the profiler recorded no device time for {what}")
            top = sorted(((e.device_time_total / reps / 1e3, e.key[:60]) for e in events),
                         reverse=True)[:5]
            taken.append((total_us / reps / 1e3, sum(e.count for e in events),
                          {e.key[:80]: e.count for e in events}, top))

    take(sessions)
    counts = [t[1] for t in taken]
    if kernel:
        chosen = taken if len(set(counts)) == 1 and counts[0] == reps else None
    else:
        chosen = taken if max(counts) - min(counts) <= lost else None
        if chosen is None:
            print(f"chip_smoke: the profiler recorded {counts} device operations of "
                  f"{what} in {sessions} sessions of {reps} calls each; taking up to "
                  f"{sessions} more")
            while chosen is None and len(taken) < 2 * sessions:
                take(1)
                chosen = _agreeing(taken, sessions, lost, reps, complete=True)
            chosen = chosen or _agreeing(taken, sessions, lost, reps, complete=False)
            if chosen is not None:
                print(f"chip_smoke: {what}: {sessions} of {len(taken)} sessions agree "
                      f"({[t[1] for t in chosen]}); left out "
                      f"{[t[1] for t in taken if all(t is not u for u in chosen)]}")
    if chosen is None:
        fail(f"the profiler recorded {[t[1] for t in taken]} device operations of {what} "
             f"in sessions of {reps} calls each: {[t[2] for t in taken]}")
    return [t[0] for t in chosen], chosen[-1][3]


def device_ms(fn, reps: int, kernel: str = "") -> float:
    """The median of session_times.  When its sessions' times differ by
    more than PROFILE_SPREAD of it, it reads again over PROFILE_SESSIONS + 2
    sessions and returns their median; it fails unless the middle
    PROFILE_SESSIONS of those lie within PROFILE_SPREAD of it.  One session
    of three now and then reads far off the other two (B2 at B=16: 0.0090
    against 0.0058 ms twice, no record lost), and the retake lets one such
    session on either side go without moving the reading."""
    what = kernel or "fn"
    times, _ = session_times(fn, reps, kernel)
    median = float(np.median(times))
    if max(times) - min(times) <= PROFILE_SPREAD * median:
        return median
    print(f"chip_smoke: device times of {what} over {PROFILE_SESSIONS} sessions "
          f"{times} differ by more than {PROFILE_SPREAD:.0%}; reading again")
    times = sorted(session_times(fn, reps, kernel,
                                 sessions=PROFILE_SESSIONS + 2)[0])
    median = float(np.median(times))
    middle = times[1:-1]
    if max(middle) - min(middle) > PROFILE_SPREAD * median:
        fail(f"device times of {what} differ by more than {PROFILE_SPREAD:.0%} "
             f"over the middle {PROFILE_SESSIONS} of {len(times)} sessions: {times}")
    return median


def bound_ms(n_bytes: float, flops: float, flops_per_s: float):
    """Least time on this card: the larger of the bytes over the HBM rate
    and the operations over the peak rate of their type.
    Returns (ms, "bytes"|"operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def warp_bound_ms(b: int, h: int, w: int, c: int, out_bytes: int):
    """The warp: each uint8 input byte read and each output written once
    (in either layout), against the 16-tap weighted sum each output value
    needs (16 multiply-adds = 32 flops) plus the epilogue's 4, in float32
    outside the tensor cores."""
    values = b * h * w * c
    return bound_ms(values * (1 + out_bytes) + b * 8 * 4, values * (32 + 4),
                    F32_FLOPS_PER_S)


def photometric_bound_ms(b: int, h: int, w: int, c: int, out_bytes: int,
                         per_sample: bool = True):
    """The photometric pass: each uint8 input byte read and each output
    written once (+ the per-sample alpha, beta and flip, 9 bytes a sample),
    against 7 float32 flops per value (multiply, multiply-add, clip,
    subtract, divide); the eval form (per_sample False) reads no scalars
    and does 2 (subtract, divide)."""
    values = b * h * w * c
    return bound_ms(values * (1 + out_bytes) + (b * 9 if per_sample else 0),
                    values * (7 if per_sample else 2), F32_FLOPS_PER_S)


def stem_bound_ms(b: int, h: int, w: int, elem_bytes: int):
    """The fused stem: 147 multiply-adds for each of the B*(H/2)*(W/2)*64
    conv outputs, at the tensor cores' bf16 rate (float32 outside them for
    float32), against the planar input read and the pooled NHWC output
    written once (+ the folded weights and bias)."""
    flops = b * (h // 2) * (w // 2) * 64 * 147 * 2
    n_bytes = (b * 3 * h * w + b * (h // 4) * (w // 4) * 64
               + 64 * 147 + 64) * elem_bytes
    rate = BF16_FLOPS_PER_S if elem_bytes == 2 else F32_FLOPS_PER_S
    return bound_ms(n_bytes, flops, rate)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits)."""
    mag = x.abs().float().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_counts():
    from medseg_tpu_torch.ops.kernels.photometric import fused_photometric
    from medseg_tpu_torch.ops.kernels.stem_kernel import stem_conv_pool
    from medseg_tpu_torch.ops.kernels.warp_kernel import warp_affine_kernel

    return {"warp_affine": warp_affine_kernel, "fused_photometric": fused_photometric,
            "stem_conv_pool": stem_conv_pool}


def reset_counts() -> None:
    for fn in kernel_counts().values():
        fn.launches = 0


def read_counts(path: str, expected: dict) -> dict:
    """The launch counts just after a path; fails unless they are exactly
    `expected` (a kernel that is not expected must not have launched)."""
    got = {name: fn.launches for name, fn in kernel_counts().items()}
    want = {name: expected.get(name, 0) for name in got}
    if got != want:
        fail(f"{path}: kernel launches {got}, expected {want}")
    return got


def check_warp_kernel(card: str):
    """The warp kernel against its plain version in nine forms; returns the
    main-path form's record (error and times)."""
    from medseg_tpu_torch.core.config import AugmentConfig, IMAGENET_MEAN, IMAGENET_STD
    from medseg_tpu_torch.ops.augment import (_combined_matrices, envelope_edge_matrices,
                                              sample_augment_params)
    from medseg_tpu_torch.ops.kernels.warp_kernel import warp_affine_kernel
    from medseg_tpu_torch.ops.warp_fast import warp_affine_fast

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mean = tuple(m * 255.0 for m in IMAGENET_MEAN)
    std = tuple(s * 255.0 for s in IMAGENET_STD)

    def inputs(b, c):
        imgs = torch.randint(0, 256, (b, SIZE, SIZE, c), generator=gen,
                             device=dev, dtype=torch.uint8)
        params = sample_augment_params(gen, b, AugmentConfig())
        return imgs, _combined_matrices(params, SIZE, SIZE), params

    # (name, batch, channels, kwargs, tolerance, why)
    cases = []
    imgs, mats, params = inputs(BATCH, 3)
    main_kw = dict(out_dtype=torch.bfloat16, alpha=params.alpha,
                   beta=params.beta, mean=mean, std=std)
    main_case = "bilinear C=3 epilogue bf16 (main path)"
    cases.append((main_case, imgs, mats, main_kw, 2.0 ** -6,
                  "one bf16 ulp at the output's largest magnitude (|x| < 4)"))
    imgs8, mats8, p8 = inputs(8, 3)
    cases.append(("bilinear C=3 f32", imgs8, mats8, {}, 1e-3,
                  "same float32 operation order, no FMA: expect 0"))
    imgs1, mats1, _ = inputs(8, 1)
    cases.append(("nearest C=1 f32", imgs1, mats1, dict(nearest=True), 0.0,
                  "nearest copies source bytes: exact"))
    imgs4, mats4, p4 = inputs(8, 4)
    cases.append(("bilinear C=4 mask plane mean 0 std 1, f32", imgs4, mats4,
                  dict(alpha=p4.alpha, beta=p4.beta, mean=mean + (0.0,),
                       std=std + (1.0,)), 1e-3,
                  "same float32 operation order, no FMA: expect 0"))
    cases.append(("bilinear C=3 epilogue bf16 planar (stem path)", imgs, mats,
                  dict(main_kw, planar=True), 2.0 ** -6,
                  "one bf16 ulp at the output's largest magnitude (|x| < 4)"))
    cases.append(("bilinear C=3 f32 planar", imgs8, mats8, dict(planar=True),
                  1e-3, "same float32 operation order, no FMA: expect 0"))
    edge = envelope_edge_matrices(SIZE, SIZE, dev)
    imgs_e = imgs8[:edge.shape[0]].contiguous()
    p_e = dict(alpha=p8.alpha[:edge.shape[0]], beta=p8.beta[:edge.shape[0]])
    cases.append(("envelope edge (+-15 deg, scale 0.9/1.1, 5% shift, flip) "
                  "bilinear epilogue bf16", imgs_e, edge,
                  dict(main_kw, **p_e), 0.0, "bit for bit"))
    cases.append(("envelope edge nearest epilogue bf16 planar", imgs_e, edge,
                  dict(main_kw, nearest=True, planar=True, **p_e), 0.0,
                  "bit for bit"))
    clip = torch.tensor([[[1.0, 0.0, 0.0], [0.9, 1.0, -20.0]],
                         [[0.8, 0.3, 5.0], [-0.2, 2.5, -40.0]]], device=dev)
    cases.append(("line shifts clipped at MAX_SHIFT, rows beyond the staging, "
                  "f32", imgs8[:2].contiguous(), clip, {}, 0.0,
                  "bit for bit: rows past the staged 96 are computed from the "
                  "image by the same code"))
    errs = {}
    for name, x, m, kw, tol, why in cases:
        got = warp_affine_kernel(x, m, **kw)
        torch.cuda.synchronize()
        want = warp_affine_fast(x, m, **kw)
        err = errs[name] = (got.float() - want.float()).abs().max().item()
        print(f"[{card}] warp kernel vs plain, {name}: max_abs_err={err} "
              f"tol={tol} ({why})")
        if not err <= tol:
            fail(f"warp kernel disagrees with its plain version ({name}): "
                 f"{err} > {tol}")

    ms = device_ms(lambda: warp_affine_kernel(imgs, mats, **main_kw), 50,
                   "warp_affine_kernel<")
    planar_ms = device_ms(lambda: warp_affine_kernel(imgs, mats, **main_kw,
                                                     planar=True), 50,
                          "warp_affine_kernel<")
    plain_ms = device_ms(lambda: warp_affine_fast(imgs, mats, **main_kw), 5)
    b_ms, b_by = warp_bound_ms(BATCH, SIZE, SIZE, 3, out_bytes=2)
    print(f"[{card}] warp kernel B={BATCH} {SIZE}x{SIZE}x3 u8->bf16 with "
          f"epilogue: kernel {ms:.4f} ms (planar out {planar_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); no single PyTorch "
          f"call computes this two-pass warp, so library_ms is null")
    return {"max_abs_err": errs[main_case], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_photometric_kernel(card: str):
    """The photometric kernel against its plain version in sixteen forms,
    all at tolerance 0 (same float32 operation order, no FMA): the eval
    form (alpha, beta and flip None, float32 out) and the explicit alpha=1,
    beta=0, no-flip form, each at the eval path's B=16 (the seg eval's
    too) and at B=128; the eval form with bf16 out at B=128 and B=8, as
    the train and seg paths validate; sampled
    alpha, beta and flips with bf16 out at B=128; C=1 and C=4 on the
    vector path; the scalar path (W=250, and an input one byte past
    16-byte alignment); and the eval form f32 at the serve path's B=1, 2,
    4 and 8 and batch_predict's B=64.  Times the B=128 forms, the B=16
    forms and the serve path's B=1 and B=8 warm, the eval path's form also
    with a cold L2, beside a same-traffic conversion (`images.to(dtype)`)
    timed the same way.  Returns the eval path's form's record, its time
    the cold reading."""
    from medseg_tpu_torch.core.config import AugmentConfig, IMAGENET_MEAN, IMAGENET_STD
    from medseg_tpu_torch.ops.augment import sample_augment_params
    from medseg_tpu_torch.ops.kernels.photometric import (
        fused_photometric, fused_photometric_reference)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def images(b, w=SIZE, c=3):
        return torch.randint(0, 256, (b, SIZE, w, c), generator=gen, device=dev,
                             dtype=torch.uint8)

    def sampled(b):
        p = sample_augment_params(gen, b, AugmentConfig())
        flip = p.flip.clone()
        flip[:2] = torch.tensor([True, False])  # both kinds, whatever the draw
        return p.alpha, p.beta, flip

    def explicit(b):
        ones = torch.ones(b, device=dev)
        return ones, torch.zeros_like(ones), torch.zeros(b, dtype=torch.bool, device=dev)

    none = (None, None, None)
    img16, img128 = images(EVAL_BATCH), images(BATCH)
    misaligned = torch.empty(8 * SIZE * SIZE * 3 + 1, dtype=torch.uint8,
                             device=dev)[1:].view(8, SIZE, SIZE, 3)
    misaligned.copy_(images(8))
    norm3 = dict(mean=IMAGENET_MEAN, std=IMAGENET_STD)
    path_case = "eval form (alpha, beta, flip None) f32 B=16 (eval path)"
    # (name, images, (alpha, beta, flip), out dtype, mean/std)
    cases = [(path_case, img16, none, torch.float32, norm3),
             ("eval form f32 B=128", img128, none, torch.float32, norm3),
             ("eval form bf16 B=128 (train path's validation)", img128, none,
              torch.bfloat16, norm3),
             ("alpha=1, beta=0, no flip f32 B=16", img16, explicit(EVAL_BATCH),
              torch.float32, norm3),
             ("alpha=1, beta=0, no flip f32 B=128", img128, explicit(BATCH),
              torch.float32, norm3),
             ("sampled alpha/beta/flip bf16 B=128", img128, sampled(BATCH),
              torch.bfloat16, norm3),
             ("C=1 vector path, sampled, f32 B=8", images(8, c=1), sampled(8),
              torch.float32, dict(mean=(0.5,), std=(0.25,))),
             ("C=4 vector path (mask plane mean 0 std 1/255), sampled, bf16 B=8",
              images(8, c=4), sampled(8), torch.bfloat16,
              dict(mean=IMAGENET_MEAN + (0.0,), std=IMAGENET_STD + (1 / 255,))),
             ("scalar path: W=250, sampled, f32 B=8", images(8, w=250), sampled(8),
              torch.float32, norm3),
             ("scalar path: input 1 byte past 16-byte alignment, sampled, bf16 B=8",
              misaligned, sampled(8), torch.bfloat16, norm3),
             ("eval form bf16 B=8 (seg path's validation)", images(SEG_BATCH), none,
              torch.bfloat16, norm3)]
    # the serve path's forms: f32 at every micro-batch size, and batch_predict's
    serve_cases = {b: f"eval form f32 B={b} (serve path)" for b in SERVE_BATCHES}
    cases += [(name, images(b), none, torch.float32, norm3)
              for b, name in serve_cases.items()]
    cases.append((f"eval form f32 B={PREDICT_BATCH} (batch_predict)",
                  images(PREDICT_BATCH), none, torch.float32, norm3))
    serve_timed = (serve_cases[1], serve_cases[max(SERVE_BATCHES)])
    timed = [c[0] for c in cases[:6]] + list(serve_timed)
    errs = {}
    for name, x, scalars, dtype, norm in cases:
        got = fused_photometric(x, *scalars, out_dtype=dtype, **norm)
        torch.cuda.synchronize()
        want = fused_photometric_reference(x, *scalars, out_dtype=dtype, **norm)
        err = errs[name] = (got.float() - want.float()).abs().max().item()
        print(f"[{card}] photometric kernel vs plain, {name}: max_abs_err={err} "
              f"tol=0 (same float32 operation order, no FMA)")
        if err != 0.0 or got.shape != x.shape or got.dtype != dtype:
            fail(f"photometric kernel disagrees with its plain version ({name}): {err}")

    # A cold L2: 64 MB written before each call evicts the 15.7 MB that
    # B=16 moves; the kernel-name filters leave that write out.
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    clear = scratch.zero_
    kernel_name, copy_name = "photometric_kernel<", "direct_copy_kernel"
    records = {}
    for name, x, scalars, dtype, norm in (c for c in cases if c[0] in timed):
        run = lambda: fused_photometric(x, *scalars, out_dtype=dtype, **norm)
        convert = lambda: x.to(dtype)
        # the serve forms run for microseconds: readings without the spread
        # rule (the median of the sessions), which gate nothing
        timer = (device_ms if name not in serve_timed else
                 lambda fn, reps, k="": float(np.median(session_times(fn, reps, k)[0])))
        ms = timer(run, 100, kernel_name)
        conv_ms = timer(convert, 100, copy_name)
        plain_ms = timer(lambda: fused_photometric_reference(
            x, *scalars, out_dtype=dtype, **norm), 10)
        b_ms, b_by = photometric_bound_ms(x.shape[0], SIZE, SIZE, 3, dtype.itemsize,
                                          per_sample=scalars[0] is not None)
        timing = (f"kernel {ms:.4f} ms ({b_ms / ms:.0%} of the bound), same-traffic "
                  f"x.to({dtype}) {conv_ms:.4f} ms")
        if name == path_case:
            ms = device_ms(lambda: (clear(), run()), 100, kernel_name)
            cold_conv_ms = device_ms(lambda: (clear(), convert()), 100, copy_name)
            timing = (f"cold L2: kernel {ms:.4f} ms ({b_ms / ms:.0%} of the bound), "
                      f"same-traffic x.to({dtype}) {cold_conv_ms:.4f} ms; warm: "
                      + timing)
        print(f"[{card}] photometric kernel {name}: {timing}, plain {plain_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}); no single PyTorch call computes "
              f"flip + brightness/contrast + normalize, so library_ms is null")
        records[name] = {"max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return records[path_case]


def check_stem_kernel(card: str):
    """The stem kernel against its plain version (a float32 conv, bias,
    ReLU and pool): float32 at B=4, 64px; a constant-1 input at B=2, 32px,
    which exposes any border mismatch; bf16 (the tensor-core form) on
    ragged tiles with an odd batch, on a constant-1 input, and at the stem
    path's B=128, 256px on the warp kernel's planar output.  Returns the stem path's
    record (the bf16 case), with the cuDNN composite (conv2d + bias + relu + max_pool2d in
    bf16) as its library time."""
    import torch.nn.functional as F

    from medseg_tpu_torch.core.config import AugmentConfig, IMAGENET_MEAN, IMAGENET_STD
    from medseg_tpu_torch.ops.augment import _combined_matrices, sample_augment_params
    from medseg_tpu_torch.ops.kernels.stem_kernel import (stem_conv_pool,
                                                          stem_conv_pool_reference)
    from medseg_tpu_torch.ops.kernels.warp_kernel import warp_affine_kernel

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def weights(dtype):
        w = torch.randn(64, 3, 7, 7, generator=gen, device=dev) * 0.1
        return w.to(dtype), (torch.randn(64, generator=gen, device=dev) * 0.1).to(dtype)

    imgs = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=gen,
                         device=dev, dtype=torch.uint8)
    p = sample_augment_params(gen, BATCH, AugmentConfig())
    planes = warp_affine_kernel(
        imgs, _combined_matrices(p, SIZE, SIZE), out_dtype=torch.bfloat16,
        alpha=p.alpha, beta=p.beta, mean=tuple(m * 255.0 for m in IMAGENET_MEAN),
        std=tuple(s * 255.0 for s in IMAGENET_STD), planar=True)
    w16, b16 = weights(torch.bfloat16)
    path_case = "bf16 B=128 256px planar from the warp kernel (stem path)"
    # (name, planes, weight, bias, absolute tolerance, bf16 ulps, why)
    cases = [("f32 B=4 64px", torch.randn(4, 3 * 64, 64, generator=gen, device=dev),
              *weights(torch.float32), 1e-4, 0, "float32 summation order"),
             ("constant-1 f32 B=2 32px (borders)", torch.ones(2, 96, 32, device=dev),
              *weights(torch.float32), 1e-4, 0, "float32 summation order"),
             ("ragged bf16 B=3 36x68 (H/4, W/4 not multiples of 8; "
              "element-wise staging)",
              torch.randn(3, 3 * 36, 68, generator=gen, device=dev).to(torch.bfloat16),
              *weights(torch.bfloat16), 1e-5, 1, "one bf16 ulp + 1e-5"),
             ("ragged bf16 B=3 44x72 (16-byte staging)",
              torch.randn(3, 3 * 44, 72, generator=gen, device=dev).to(torch.bfloat16),
              *weights(torch.bfloat16), 1e-5, 1, "one bf16 ulp + 1e-5"),
             ("constant-1 bf16 B=1 40x48 (borders)",
              torch.ones(1, 3 * 40, 48, device=dev, dtype=torch.bfloat16),
              *weights(torch.bfloat16), 1e-5, 1, "one bf16 ulp + 1e-5"),
             (path_case, planes, w16, b16, 1e-5, 1,
              "one bf16 ulp of the element's magnitude, as the float32 sums "
              "may round to neighbouring bf16 values, plus 1e-5 where they "
              "straddle ReLU's zero")]
    errs = {}
    for name, x, w, b, atol, ulps, why in cases:
        got = stem_conv_pool(x, w, b)
        torch.cuda.synchronize()
        want = stem_conv_pool_reference(x, w, b)
        diff = (got.float() - want.float()).abs()
        allowed = atol + ulps * bf16_ulp(torch.maximum(got.float().abs(),
                                                       want.float().abs()))
        errs[name] = diff.max().item()
        print(f"[{card}] stem kernel vs plain, {name}: max_abs_err={errs[name]} "
              f"tol={atol}{f' + {ulps} bf16 ulp' if ulps else ''} ({why})")
        if not (diff <= allowed).all() or got.shape != want.shape:
            fail(f"stem kernel disagrees with its plain version ({name}): "
                 f"{errs[name]}")

    # the stem path's case, by its own names: planes, w16, b16
    def library():
        y = F.conv2d(planes.view(BATCH, 3, SIZE, SIZE), w16, stride=2, padding=3)
        y = torch.relu(y + b16[None, :, None, None])
        return F.max_pool2d(y, 3, 2, padding=1)

    ms = device_ms(lambda: stem_conv_pool(planes, w16, b16), 20,
                   "stem_conv_pool_bf16_kernel")
    plain_ms = device_ms(lambda: stem_conv_pool_reference(planes, w16, b16), 5)
    library_ms = device_ms(library, 20)
    b_ms, b_by = stem_bound_ms(BATCH, SIZE, SIZE, 2)
    print(f"[{card}] stem kernel B={BATCH} {SIZE}x{SIZE} bf16 planar -> "
          f"[{BATCH},{SIZE // 4},{SIZE // 4},64]: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library {library_ms:.4f}"
          f" ms (cuDNN composite: conv2d + bias + relu + max_pool2d, 4 calls, "
          f"NCHW out)")
    return {"max_abs_err": errs[path_case], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def run_main_path(card: str):
    """The fused aug+infer path at full width; returns the launches seen."""
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.synthetic import synthetic_cls
    from medseg_tpu_torch.eval.metrics import classification_metrics
    from medseg_tpu_torch.models.resnet import resnet18
    from medseg_tpu_torch.ops.augment import augment_batch

    t0 = time.perf_counter()
    ds = synthetic_cls(n=N_SAMPLES, img_size=SIZE, seed=SEED)
    loader = BatchLoader(ds, BATCH, shuffle=True, seed=SEED, drop_last=True,
                         device_cache=True)
    torch.manual_seed(SEED)
    model = resnet18(dtype=torch.bfloat16).eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print(f"[{card}] set-up (synthetic set N={N_SAMPLES} at {SIZE}px, "
          f"model): {time.perf_counter() - t0:.3f} s")

    def step(images):
        x, _ = augment_batch(gen, images, out_dtype=torch.bfloat16)
        return x, model(x)

    with torch.inference_mode():
        images, _ = next(iter(loader))  # warm-up: cuDNN plans, allocator
        step(images)
        torch.cuda.synchronize()

        reset_counts()
        preds, labels, aug_ms, fwd_ms = [], [], [], []
        t0 = time.perf_counter()
        for images, target in loader:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            x, _ = augment_batch(gen, images, out_dtype=torch.bfloat16)
            ev[1].record()
            logits = model(x)
            ev[2].record()
            preds.append(logits.argmax(-1))
            labels.append(target)
            aug_ms.append(ev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_batches = len(aug_ms)
        launches = read_counts("aug+infer path", {"warp_affine": n_batches})
        if logits.shape != (BATCH, 3) or not torch.isfinite(logits).all():
            fail(f"bad logits: shape {tuple(logits.shape)}, "
                 f"finite={bool(torch.isfinite(logits).all())}")
        # the bf16 forward against a float32 forward of the same weights on
        # the same augmented batch (TF32 off): bf16 keeps 8 significant
        # bits, and rounding builds up over 20 layers
        ref = resnet18(dtype=torch.float32)
        ref.load_state_dict(model.state_dict())
        ref_logits = ref.eval()(x.float())
        err = (logits - ref_logits).abs().max().item()
        tol = 0.05 * max(1.0, ref_logits.abs().max().item())
        print(f"[{card}] ResNet18 bf16 vs f32 logits on the last batch: "
              f"max_abs_err={err:.5f} tol={tol:.5f}")
        if not err <= tol:
            fail(f"bf16 forward disagrees with float32: {err} > {tol}")

    metrics = classification_metrics(torch.cat(preds).cpu().numpy(),
                                     torch.cat(labels).cpu().numpy())
    cm = metrics["confusion_matrix"]
    if cm.sum() != n_batches * BATCH or not 0.0 <= metrics["accuracy"] <= 100.0:
        fail(f"bad metrics: {metrics}")
    a_ms = [e[0].elapsed_time(e[1]) for e in aug_ms]
    f_ms = [e[1].elapsed_time(e[2]) for e in aug_ms]
    print(f"[{card}] main path, {n_batches} batches of {BATCH} at {SIZE}px "
          f"(random weights, seed {SEED}): augment_batch {np.mean(a_ms):.4f} ms"
          f"/batch, ResNet18 bf16 forward {np.mean(f_ms):.4f} ms/batch, "
          f"whole step {n_batches * BATCH / wall:.1f} img/s "
          f"(loader+augment+forward+argmax, host clock); "
          f"accuracy {metrics['accuracy']:.2f}% (untrained)")
    return launches


def randomize_bn_stats(model, gen: torch.Generator) -> None:
    """Running statistics away from their init values, so folding them is
    real work."""
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            dev = m.running_mean.device
            m.running_mean.copy_(torch.randn(m.num_features, generator=gen,
                                             device=dev) * 0.1)
            m.running_var.copy_(torch.rand(m.num_features, generator=gen,
                                           device=dev) + 0.5)


def run_eval_path(card: str):
    """`medseg eval` for classification at full width: a random ResNet18
    written as the reference's .pt -> test_all_models over a synthetic test
    split (ResNet50, VGG16/19 and CLIP have no weights and are skipped) ->
    print_summary -> save_results_to_csv, read back; returns the launches."""
    from medseg_tpu_torch.core.config import EvalConfig, IMAGENET_MEAN, IMAGENET_STD
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.synthetic import synthetic_cls
    from medseg_tpu_torch.eval.csv_io import save_results_to_csv
    from medseg_tpu_torch.eval.harness import print_summary, test_all_models
    from medseg_tpu_torch.models.resnet import resnet18
    from medseg_tpu_torch.ops.augment import preprocess_eval_batch
    from medseg_tpu_torch.ops.image import normalize_imagenet

    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        root = Path(tmp)
        torch.manual_seed(SEED)
        model = resnet18()
        randomize_bn_stats(model, torch.Generator(device="cuda").manual_seed(SEED))
        (root / "weights" / "classification_models").mkdir(parents=True)
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   root / "weights" / "classification_models" / "ResNet18_best_acc.pt")
        loader = BatchLoader(synthetic_cls(n=EVAL_SAMPLES, img_size=SIZE, seed=SEED),
                             EVAL_BATCH, shuffle=False)
        cfg = EvalConfig(batch_size=EVAL_BATCH, weights_root=str(root / "weights"),
                         results_dir=str(root / "results"))
        logs = []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results = test_all_models(loader, None, cfg, log=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts("eval path", {"fused_photometric": len(loader)})

        skipped = [m for m in ("ResNet50", "VGG16", "VGG19", "CLIP")
                   if f"\n[WARNING] Weights not found for {m}" in logs]
        if list(results) != ["ResNet18"] or len(skipped) != 4:
            fail(f"eval path: results for {list(results)}, skipped {skipped}; "
                 f"log: {logs}")
        res = results["ResNet18"]
        if res["confusion_matrix"].sum() != EVAL_SAMPLES:
            fail(f"eval path: confusion matrix sums to {res['confusion_matrix'].sum()}")
        print_summary(results)
        cls_csv = root / "results" / "classification_test_results.csv"
        save_results_to_csv(results, str(cls_csv),
                            str(root / "results" / "segmentation_test_results.csv"))
        with open(cls_csv, newline="") as f:
            rows = list(csv.DictReader(f))
        want = {k: res[k] for k in ("accuracy", "precision", "recall", "f1")}
        if (len(rows) != 1 or rows[0].pop("Model") != "ResNet18"
                or {k: float(v) for k, v in rows[0].items()} != want):
            fail(f"eval path: the CSV reads back as {rows}, not {want}")

        # one batch: the kernel's eval form is the plain normalization, bit
        # for bit, in one device operation; and a batch's device time split
        # between the preprocessing and the forward
        images, _ = next(iter(loader))
        x, _ = preprocess_eval_batch(images)
        if not torch.equal(x, normalize_imagenet(images, IMAGENET_MEAN, IMAGENET_STD)):
            fail("eval path: the photometric kernel's eval form differs from "
                 "normalize_imagenet")
        preprocess = lambda: preprocess_eval_batch(images)
        ops = [sum(e.count for e in events) for events in _sessions(preprocess, 1)]
        if ops != [1] * PROFILE_SESSIONS:
            fail(f"eval path: one preprocess_eval_batch call ran {ops} device "
                 f"operations in {PROFILE_SESSIONS} profiler sessions, not 1")
        pre_ms = device_ms(preprocess, 50, "photometric_kernel<")
        with torch.inference_mode():
            fwd_ms = device_ms(lambda: model.eval()(x), 10)
    print(f"[{card}] eval path, ResNet18 float32 (random weights, seed {SEED}), "
          f"{EVAL_SAMPLES} images at {SIZE}px in {len(loader)} batches of "
          f"{EVAL_BATCH}: {wall:.3f} s, {EVAL_SAMPLES / wall:.1f} img/s (host "
          f"clock, loader + preprocess + forward + metrics, weight loading and "
          f"the four skips included); accuracy {res['accuracy']:.2f}%; "
          f"confusion matrix sums to {res['confusion_matrix'].sum()}; the CSV "
          f"reads back to the metrics; photometric kernel == normalize_imagenet "
          f"on one batch")
    print(f"[{card}] eval path, one batch of {EVAL_BATCH} by device time: "
          f"preprocess_eval_batch {pre_ms:.4f} ms (one device operation), "
          f"ResNet18 float32 forward {fwd_ms:.4f} ms")
    return launches


def run_stem_path(card: str):
    """The fused-stem inference forward at full width: one batch of B=128
    through the warp kernel's planar bf16 output and apply_with_stem_kernel
    on ResNet18 bf16 (random BN running statistics), against model(x) on the
    same batch in NHWC; returns the launches."""
    from medseg_tpu_torch.core.config import AugmentConfig, IMAGENET_MEAN, IMAGENET_STD
    from medseg_tpu_torch.data.synthetic import synthetic_cls
    from medseg_tpu_torch.models.resnet import apply_with_stem_kernel, resnet18
    from medseg_tpu_torch.ops.augment import _combined_matrices, sample_augment_params
    from medseg_tpu_torch.ops.kernels.warp_kernel import warp_affine_kernel

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    torch.manual_seed(SEED + 3)
    model = resnet18(dtype=torch.bfloat16).eval()
    randomize_bn_stats(model, gen)
    images = torch.from_numpy(synthetic_cls(n=BATCH, img_size=SIZE, seed=SEED + 3)
                              .images).cuda()
    p = sample_augment_params(gen, BATCH, AugmentConfig())
    kw = dict(out_dtype=torch.bfloat16, alpha=p.alpha, beta=p.beta,
              mean=tuple(m * 255.0 for m in IMAGENET_MEAN),
              std=tuple(s * 255.0 for s in IMAGENET_STD))
    mats = _combined_matrices(p, SIZE, SIZE)

    with torch.inference_mode():
        x = warp_affine_kernel(images, mats, **kw)  # NHWC, for model(x)
        ref = model(x)  # warm-up of the deep stages' cuDNN plans, too
        torch.cuda.synchronize()
        reset_counts()
        planes = warp_affine_kernel(images, mats, planar=True, **kw)
        logits = apply_with_stem_kernel(model, planes, planar=True)
        torch.cuda.synchronize()
        launches = read_counts("stem path", {"warp_affine": 1, "stem_conv_pool": 1})

        if logits.shape != (BATCH, 3) or not torch.isfinite(logits).all():
            fail(f"stem path: bad logits, shape {tuple(logits.shape)}")
        err = (logits - ref).abs().max().item()
        tol = 0.05 * max(1.0, ref.abs().max().item())
        print(f"[{card}] stem path logits vs model(x) on the same batch: "
              f"max_abs_err={err:.5f} tol={tol:.5f} (5% of max(1, |logit|max): "
              f"bf16 rounds at other places through 20 layers)")
        if not err <= tol:
            fail(f"stem path disagrees with model(x): {err} > {tol}")
        # device time of every kernel each forward runs, in turns
        stem_fwd = lambda: apply_with_stem_kernel(model, planes, planar=True)
        fwd = lambda: model(x)
        turns = [("stem", stem_fwd), ("model", fwd), ("model", fwd),
                 ("stem", stem_fwd)]
        times = {"stem": [], "model": []}
        for name, fn in turns:
            times[name].append(device_ms(fn, 10))
    stem_ms, fwd_ms = (float(np.mean(times[k])) for k in ("stem", "model"))
    print(f"[{card}] stem path, ResNet18 bf16 B={BATCH} at {SIZE}px, device "
          f"time of all kernels per forward, in turns (stem, model, model, "
          f"stem): apply_with_stem_kernel {times['stem'][0]:.4f} / "
          f"{times['stem'][1]:.4f} ms, model(x) {times['model'][0]:.4f} / "
          f"{times['model'][1]:.4f} ms; means {stem_ms:.4f} vs {fwd_ms:.4f} ms")
    return launches


EPOCH_LINE = re.compile(r"\[ResNet18\] Ep(?P<ep>\d+): TrainLoss (?P<train>\S+) "
                        r"\(Acc \S+%\) \| ValLoss (?P<val>\S+) \| ValAcc \S+%")
SEG_EPOCH_LINE = re.compile(r"\[ResNetUnet\] Ep(?P<ep>\d+): TrainLoss (?P<train>\S+) "
                            r"\| ValLoss (?P<val>\S+) \| IoU (?P<iou>\S+)")


def _epoch_lines(logs, path: str, pattern=EPOCH_LINE):
    """(epoch, train loss, val loss) of each epoch line; fails unless every
    loss is finite."""
    rows = [(int(m["ep"]), float(m["train"]), float(m["val"]))
            for m in map(pattern.match, logs) if m]
    if not all(math.isfinite(r[1]) and math.isfinite(r[2]) for r in rows):
        fail(f"{path}: a logged loss is not finite: {logs}")
    return rows


def _check_card_against_cpu(card: str, path: str, what: str, build, step, loss64,
                            images, targets, factor: float = 2.0, card64: bool = False,
                            bf16: bool = True, zero_grad=None, grad_floor: float = 0.0,
                            update_floor: float = 0.0, recipe=None):
    """Gates 4 and 5 of a train path: three float32 steps (TF32 off) on the
    card and on the CPU through the port's own step, from the same weights
    on one pre-augmented batch; then one bf16 step's loss against the
    float32 step's.  Fails unless all are within their tolerances.

    build(device, dtype) -> (model in training mode, optimizer over its
    path's trainable parameters at PARITY_LR), from the path's weights; a
    float64 model computes in float64 throughout.  step(model, optimizer,
    x, y, generator) -> the loss (the port's train step).  loss64(model, x,
    y) -> the path's loss written out in float64.

    Gate 4 holds the card's float32 result against a float64 run of the
    same steps on the CPU: its distance from it (largest element and L2)
    may be twice the CPU float32 run's own.  The train-mode gradient at
    256px is ill-conditioned in float32 (batch statistics over B*128*128
    values a channel, through the BatchNorms): card and CPU differed by
    4.3e-3 of ResNet18's gradient L2 norm, mostly in early BatchNorm
    biases, where a fixed gate of 1e-3 had been set, so no fixed tolerance
    both holds and means something.  Card against CPU is printed as a
    reading.

    factor: the multiple of the CPU float32 run's distance allowed (2).
    card64: the same steps also run in float64 on the card, and gate 4
    then also holds them to the CPU's float64 run within 1e-9 of each
    part's largest magnitude: the same arithmetic in both, so only a
    fault on the card (a wrong layout, kernel or blend) parts them.
    bf16: gate 5 (a float32 recipe, the finetuners', has none).  A part
    with no tensors (a model without running statistics) is skipped.
    zero_grad(name): parameters whose gradient is zero in exact arithmetic
    (attention's key bias: softmax ignores a constant added to a query's
    logits).  Their float32 gradients are rounding noise of a zero, whose
    size depends on the kernel's summation order (on an H100, the card's
    SDPA backward left about twice the CPU's in CLIPSeg's decoder), so
    they leave the 2x comparisons and are held instead to
    |g| <= 1e-4 of the largest float64 |g| on card and CPU; the lr bound on
    every parameter's move still covers them.
    grad_floor: the step-1 gradients pass too when the card's distance is
    within this fraction of the float64 gradients' own magnitude (largest
    element, L2), float32's rounding floor where the CPU's float32 run
    lands unusually close to float64.  update_floor: the parameters after
    step 3 pass too when the card's L2 distance is within this fraction
    of the float64 run's own update (the parameters' move over the three
    steps) and every element within the AdamW bound 2*3*lr: AdamW moves an
    element with a gradient at float32's noise by up to lr a step either
    way, so such elements set the distance when the CPU's run happens to
    take their signs as float64 does.

    recipe: (kind, name) of _RECIPES, whose build, step and loss64 these
    are.  With a recipe and a CPU worker running (_CpuWorker), the CPU's
    two runs and the comparison go to the worker, which this process's
    card half hands them through a file; their lines are printed, and a
    failure fails the run, when the worker is drained (_drain_cpu_work).
    Gate 5 and the card's runs take place here at once either way."""
    opts = dict(card=card, path=path, what=what, factor=factor, card64=card64,
                grad_floor=grad_floor, update_floor=update_floor)
    runs = {"card": _parity_run(build, step, loss64, images, targets, "cuda", torch.float32)}
    if card64:
        runs["card float64"] = _parity_run(build, step, loss64, images, targets, "cuda",
                                           torch.float64)
    if recipe is not None and _WORKER is not None:
        _WORKER.submit(dict(opts, recipe=recipe), images, targets, runs)
    else:
        runs["cpu"] = _parity_run(build, step, loss64, images, targets, "cpu", torch.float32)
        runs["float64"] = _parity_run(build, step, loss64, images, targets, "cpu",
                                      torch.float64, keep_init=update_floor > 0)
        lines, failure = _compare_runs(runs, zero_grad=zero_grad, **opts)
        print("\n".join(lines))
        if failure:
            fail(failure)
    if not bf16:
        return
    l_card = runs["card"][0]
    model, opt = build("cuda", torch.bfloat16)
    bf16_loss = step(model, opt, images.cuda(), targets.cuda(),
                     torch.Generator(device="cuda").manual_seed(SEED)).item()
    rel = abs(bf16_loss - l_card[0]) / abs(l_card[0])
    print(f"[{card}] {path}, bf16 vs float32 step loss on the same weights and "
          f"batch: {bf16_loss:.5f} vs {l_card[0]:.5f}, rel {rel:.4f} tol 0.05")
    if not rel <= 0.05:
        fail(f"{path}: bf16 loss {bf16_loss} is not within 5% of float32's {l_card[0]}")


def _parity_run(build, step, loss64, images, targets, device: str, dtype,
                keep_init: bool = False):
    """One run of gate 4: three steps from the same weights on one batch,
    through the port's step in float32 or the loss written out in float64.
    Returns (losses, step-1 gradients, state after step 3, and the
    initial parameters when keep_init, else None), all on the CPU."""
    model, opt = build(device, dtype)
    init = ({n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            if keep_init else None)
    losses, grads = [], None
    if dtype == torch.float64:
        x, y = images.to(device, dtype), targets.to(device)
    else:
        gen = torch.Generator(device=device).manual_seed(SEED)
        x, y = images.to(device), targets.to(device)
    for i in range(3):
        if dtype == torch.float64:
            loss = loss64(model, x, y)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        else:
            loss = step(model, opt, x, y, gen)
        losses.append(loss.item())
        if i == 0:
            grads = {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.grad is not None}
    return losses, grads, {k: v.cpu() for k, v in model.state_dict().items()}, init


def _compare_runs(runs: dict, card: str, path: str, what: str, factor: float,
                  card64: bool, grad_floor: float, update_floor: float, zero_grad=None):
    """Gate 4's comparisons of the runs of _check_card_against_cpu ("card",
    "cpu", "float64" and with card64 "card float64"): returns (the lines
    to print, the failure or None)."""
    lines = []
    init64 = runs["float64"][3]

    def l2(ts) -> float:
        return math.sqrt(sum(float(t.double().square().sum()) for t in ts))

    def dist(a: str, b: str, pick) -> dict:
        """Distances of run a from run b over the tensors `pick` gives."""
        ta, tb = (pick(runs[r]) for r in (a, b))
        diff = {n: ta[n].double() - tb[n].double() for n in tb}
        return {"max": max(float(d.abs().max()) for d in diff.values()),
                "l2": l2(diff.values()), "rel": l2(diff.values()) / l2(tb.values()),
                "worst": sorted(diff, key=lambda n: l2([diff[n]])
                                / max(l2([tb[n]]), 1e-30))[-3:]}

    zero_grad = zero_grad or (lambda name: False)
    params = [n for n in runs["cpu"][1] if not zero_grad(n)]  # trainable, compared
    step1 = lambda run: {n: run[1][n] for n in params}  # noqa: E731
    step3 = lambda run: {n: run[2][n] for n in params}  # noqa: E731
    stats = lambda run: {k: v for k, v in run[2].items()  # noqa: E731
                         if k.endswith(("running_mean", "running_var"))}
    l_card, l_cpu, l_ref = (runs[r][0] for r in ("card", "cpu", "float64"))
    gmax = max(float(g.abs().max()) for g in runs["float64"][1].values())
    lines.append(f"[{card}] {path}, card vs CPU float32 (TF32 off), {what}, lr {PARITY_LR}, "
                 f"3 steps: losses {l_card} vs {l_cpu} (float64 {l_ref}); largest step-1 |g| "
                 f"{gmax:.3e}")
    ok = True
    for part, pick in (("step-1 clipped gradients", step1),
                       ("parameters after step 3", step3),
                       ("running statistics after step 3", stats)):
        if not pick(runs["float64"]):
            continue
        d, floor = dist("card", "float64", pick), dist("cpu", "float64", pick)
        cc = dist("card", "cpu", pick)
        tol = {"max": factor * floor["max"], "l2": factor * floor["l2"]}
        rounding = ""
        if grad_floor and pick is step1:
            ref = pick(runs["float64"])
            tol = {"max": max(tol["max"], grad_floor * max(float(t.abs().max())
                                                           for t in ref.values())),
                   "l2": max(tol["l2"], grad_floor * l2(ref.values()))}
            rounding = f" or {grad_floor:g} of float64's own magnitude"
        if update_floor and pick is step3:
            moved = l2(runs["float64"][2][n] - init64[n] for n in params)
            tol = {"max": max(tol["max"], 2 * 3 * PARITY_LR),
                   "l2": max(tol["l2"], update_floor * moved)}
            rounding = (f" or, in L2, {update_floor:g} of float64's own update "
                        f"({moved:.3e}; largest element: the AdamW bound 2*3*lr)")
        passed = d["max"] <= tol["max"] and d["l2"] <= tol["l2"]
        ok &= passed
        lines.append(f"[{card}] {path}, {part}: card vs float64 max_abs_err="
                     f"{d['max']:.3e}, L2 {d['l2']:.3e} ({d['rel']:.3e} of float64's); tol "
                     f"{factor:g}x the CPU float32's distance from float64{rounding}: max "
                     f"{tol['max']:.3e}, L2 {tol['l2']:.3e}; CPU float32 vs float64 max "
                     f"{floor['max']:.3e}, L2 {floor['l2']:.3e}; card vs CPU max "
                     f"{cc['max']:.3e}, L2 {cc['l2']:.3e}; farthest tensors (card vs "
                     f"float64, relative L2) {d['worst']}: {'pass' if passed else 'FAIL'}")
        if card64:
            d64 = dist("card float64", "float64", pick)
            scale = max(float(t.abs().max()) for t in pick(runs["float64"]).values())
            passed = d64["max"] <= 1e-9 * scale
            ok &= passed
            lines.append(f"[{card}] {path}, {part} in float64: card vs CPU max_abs_err="
                         f"{d64['max']:.3e} tol {1e-9 * scale:.3e} (1e-9 of the largest "
                         f"magnitude, {scale:.3e}): {'pass' if passed else 'FAIL'}")
    zeros = [n for n in runs["cpu"][1] if zero_grad(n)]
    if zeros:
        noise = {r: max(float(runs[r][1][n].abs().max()) for n in zeros)
                 for r in ("card", "cpu", "float64")}
        passed = max(noise["card"], noise["cpu"]) <= 1e-4 * gmax
        ok &= passed
        lines.append(f"[{card}] {path}, the {len(zeros)} gradients zero in exact arithmetic "
                     f"(left out above): largest |g| card {noise['card']:.3e}, CPU "
                     f"{noise['cpu']:.3e}, float64 {noise['float64']:.3e}; tol {1e-4 * gmax:.3e} "
                     f"(1e-4 of the largest |g|): {'pass' if passed else 'FAIL'}")
    # AdamW moves an element by at most ~lr a step whatever its gradient
    p_max = dist("card", "float64", lambda run: {n: run[2][n] for n in runs["cpu"][1]})["max"]
    if not ok or p_max > 2 * 3 * PARITY_LR:
        return lines, (f"{path}: the card's float32 steps are farther from float64 "
                       f"than {factor:g}x the CPU's, its float64 steps are not the CPU's, "
                       f"or a parameter moved by {p_max:.3e} > 2*3*lr")
    return lines, None


class _CpuWorker:
    """One spawned process that takes the CPU halves of gate 4 for the seg
    and zoo paths (_check_card_against_cpu with a recipe): the float32 and
    float64 runs of three steps on the CPU, and the comparisons, while this
    process drives the card.  Those CPU runs were most of the zoo's gates 4
    and 5 (124 s of a 747 s run before they moved here, VGG's 33 s each).
    It computes with as many threads as this process would (the CPU float32
    run's distance from float64, gate 4's yardstick, depends on its
    reduction order: VGG19's gradients read 1.9e-2 of float64's L2 with 8
    threads and 3.2e-4 with 4, while the card's read 5.7e-3 both times), is
    stopped (SIGSTOP) while this process takes a host-clock reading
    (host_clock) and continued after, and ends with the run.  A job's
    tensors (the state, the batch and the card's runs: up to 3.8 GB for
    VGG) reach it as torch.save bytes in a shared-memory block, whose name
    goes through the queue: not as a file, to keep the run's disk writes
    down (job files added ~12 GB a run), and not through the pipe, whose
    writer thread waits for this process's interpreter lock between 64 KiB
    writes (the zoo path then waited 210 s for the worker).  Its lines come
    back to be printed when the worker is drained."""

    def __init__(self):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.threads = torch.get_num_threads()
        self.jobs, self.results = ctx.Queue(), ctx.Queue()
        self.proc = ctx.Process(target=_worker_main, daemon=True,
                                args=(self.jobs, self.results, self.threads))
        self.proc.start()
        self.pending = {}  # job id -> path
        self.blocks = {}  # job id -> its shared-memory block, until drained
        self.submitted = 0
        self.paused = 0
        self.paused_s = 0.0
        self._t_pause = 0.0

    def submit(self, opts: dict, images, targets, runs: dict) -> None:
        import io
        from multiprocessing import shared_memory

        kind, name, state = opts["recipe"]
        payload = io.BytesIO()
        torch.save({"state": state, "images": images, "targets": targets, "runs": runs},
                   payload)
        data = payload.getbuffer()
        block = shared_memory.SharedMemory(create=True, size=len(data))
        block.buf[:len(data)] = data
        del data
        job = dict(opts, id=self.submitted, recipe=(kind, name), block=block.name,
                   size=payload.tell())
        self.blocks[job["id"]] = block
        self.pending[job["id"]] = opts["path"]
        self.submitted += 1
        self.jobs.put(job)

    def pause(self) -> None:
        if self.paused == 0 and self.proc.is_alive():
            os.kill(self.proc.pid, signal.SIGSTOP)
            self._t_pause = time.perf_counter()
        self.paused += 1

    def resume(self) -> None:
        self.paused -= 1
        if self.paused == 0 and self.proc.is_alive():
            os.kill(self.proc.pid, signal.SIGCONT)
            self.paused_s += time.perf_counter() - self._t_pause

    def drain(self, card: str) -> None:
        """Waits for every job, prints its lines and fails on its failure."""
        import queue

        if not self.pending:
            return
        t0 = time.perf_counter()
        waiting = dict(self.pending)
        while self.pending:
            try:
                job_id, lines, failure = self.results.get(timeout=5)
            except queue.Empty:
                if not self.proc.is_alive():
                    fail(f"the CPU worker died (exit {self.proc.exitcode}) with gate 4 of "
                         f"{sorted(set(self.pending.values()))} to take")
                continue
            self.pending.pop(job_id)
            self._release(job_id)
            print("\n".join(lines))
            if failure:
                fail(failure)
        print(f"[{card}] CPU worker ({self.threads} threads): gate 4's CPU halves of "
              f"{sorted(set(waiting.values()))} done; waited {time.perf_counter() - t0:.1f} "
              f"s for them at the end, the worker stopped {self.paused_s:.1f} s in all for "
              f"host-clock readings")

    def _release(self, job_id: int) -> None:
        block = self.blocks.pop(job_id)
        block.close()
        block.unlink()

    def close(self) -> None:
        for job_id in list(self.blocks):
            self._release(job_id)
        if self.proc.is_alive():
            os.kill(self.proc.pid, signal.SIGCONT)
            self.proc.terminate()
            self.proc.join(10)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()
        for q in (self.jobs, self.results):
            q.cancel_join_thread()
            q.close()


_WORKER = None  # main()'s _CpuWorker


@contextlib.contextmanager
def host_clock():
    """Keeps the CPU worker stopped while a host-clock reading is taken."""
    worker = _WORKER
    if worker is None:
        yield
        return
    worker.pause()
    try:
        yield
    finally:
        worker.resume()


def _on_host_clock(fn):
    """fn under host_clock: a function whose every call is a reading."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with host_clock():
            return fn(*args, **kwargs)
    return wrapped


def _worker_main(jobs, results, threads: int) -> None:
    """The CPU worker's loop over its jobs (_cpu_half)."""
    torch.set_num_threads(threads)
    for job in iter(jobs.get, None):
        try:
            lines, failure = _cpu_half(job)
        except Exception:  # noqa: BLE001 — reported as the gate's failure
            lines, failure = [], (f"{job['path']}: gate 4's CPU half raised:\n"
                                  f"{traceback.format_exc()}")
        results.put((job["id"], lines, failure))


def _cpu_half(job: dict):
    """In the CPU worker: the job's float32 and float64 runs on the CPU
    from its recipe, then gate 4's comparisons with the card's runs.
    Returns (lines, failure or None)."""
    import io
    from multiprocessing import shared_memory

    t0 = time.perf_counter()
    block = shared_memory.SharedMemory(name=job["block"])  # unlinked by _release
    try:
        data = torch.load(io.BytesIO(block.buf[:job["size"]]), weights_only=True)
    finally:
        block.close()
    kind, name = job["recipe"]
    recipe = {"seg": _seg_recipe, "zoo": _zoo_recipe}[kind]
    build, step, loss64 = recipe(name, data["state"])
    images, targets, runs = data["images"], data["targets"], data["runs"]
    runs["cpu"] = _parity_run(build, step, loss64, images, targets, "cpu", torch.float32)
    runs["float64"] = _parity_run(build, step, loss64, images, targets, "cpu", torch.float64,
                                  keep_init=job["update_floor"] > 0)
    opts = {k: job[k] for k in ("card", "path", "what", "factor", "card64", "grad_floor",
                                "update_floor")}
    lines, failure = _compare_runs(runs, **opts)
    lines.append(f"[{job['card']}] {job['path']}: gate 4's CPU half took "
                 f"{time.perf_counter() - t0:.1f} s in the CPU worker (stops included)")
    return lines, failure


def _cls_parity(card: str, state: dict, images, labels):
    """Gates 4 and 5 of the train path: ResNet18 with dropout 0, every
    parameter trainable (stage 2), label-smoothed CE."""
    from medseg_tpu_torch.models.resnet import resnet18
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train.freeze import all_trainable, set_trainable

    def build(device, dtype):
        model = resnet18(dtype=dtype, device=device, dropout=0.0)
        model.load_state_dict(state, strict=True)
        if dtype == torch.float64:
            model.double()
            # the head casts its input to float32; here it takes float64
            model.fc.register_forward_pre_hook(
                lambda _, args: (args[0].to(dtype),) + args[1:])
        return model, S.build_optimizer(PARITY_LR, 5e-4, 1.0,
                                        set_trainable(model.train(), all_trainable))

    def loss64(model, x, y, k=3):
        target = (y[:, None] == torch.arange(k)).to(x.dtype) * 0.9 + 0.1 / k
        return -(target * torch.log_softmax(model(x), -1)).sum(-1).mean()

    _check_card_against_cpu(
        card, "train path", f"ResNet18 B={PARITY_BATCH} at {SIZE}px, stage-2 optimizer",
        build, lambda m, o, x, y, g: S.cls_train_step(m, o, x, y, g, 0.1)[0], loss64,
        images, labels)


def _batch_norm_reading(card: str, model, x, gen) -> None:
    """A reading that gates nothing: the device time of forward + backward
    of the train step's 20 BatchNorms at the step's shapes (bf16
    activations, channels-last), three ways: the port's BatchNorm2d
    (torch.native_batch_norm without running statistics, then its running
    update), F.batch_norm with float32 running statistics (the call that
    torch's own nn.BatchNorm2d makes, which picks its backend itself), and
    torch.cudnn_batch_norm, cuDNN's own, with weight, bias and statistics
    in bf16 (it takes no float32 weight beside bf16 input).  Each prints
    its costliest device operations, which name the kernels."""
    import torch.nn.functional as F

    from medseg_tpu_torch.nn.blocks import BatchNorm2d

    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, args: inputs.setdefault(m, args[0].detach().to(m.compute_dtype)))
        for m in model.modules() if isinstance(m, BatchNorm2d)]
    with torch.no_grad():
        model(x, generator=gen)
    for h in hooks:
        h.remove()
    cases = [(m, xi.requires_grad_(), torch.randn_like(xi)) for m, xi in inputs.items()]

    def params(m, dtype):
        """(weight, bias, running mean, running var): the module's own
        weight and bias in float32, else leaf copies in `dtype`."""
        w, b = ((m.weight, m.bias) if dtype == torch.float32 else
                (p.detach().to(dtype).requires_grad_() for p in (m.weight, m.bias)))
        return w, b, m.running_mean.to(dtype, copy=True), m.running_var.to(dtype, copy=True)

    f32 = {m: params(m, torch.float32) for m, _, _ in cases}
    bf16 = {m: params(m, torch.bfloat16) for m, _, _ in cases}
    ways = {
        "the port's BatchNorm2d (native_batch_norm)": (lambda m, xi: m(xi), f32),
        "F.batch_norm": (lambda m, xi: F.batch_norm(
            xi, *f32[m][2:], *f32[m][:2], True, m.momentum, m.eps), f32),
        "torch.cudnn_batch_norm (bf16 weight, bias and statistics)": (
            lambda m, xi: torch.cudnn_batch_norm(
                xi, *bf16[m], True, m.momentum, m.eps)[0], bf16)}
    with torch.no_grad():
        want = [m(xi) for m, xi, _ in cases]
    shapes = sorted({tuple(xi.shape) for _, xi, _ in cases}, reverse=True)
    print(f"[{card}] train path, BatchNorm reading: {len(cases)} BatchNorms, "
          f"inputs {shapes} bf16 channels-last")
    for way, (bn, p) in ways.items():
        def fwd_bwd(bn=bn, p=p):
            for m, xi, gy in cases:
                torch.autograd.grad(bn(m, xi), (xi, *p[m][:2]), gy)
        try:
            with torch.no_grad():
                err = max((bn(m, xi).float() - w.float()).abs().max().item()
                          for (m, xi, _), w in zip(cases, want))
            times, top = session_times(fwd_bwd, 5, what=way, lost=1)
        except RuntimeError as e:  # cuDNN may refuse the dtype or layout
            print(f"[{card}] train path, BatchNorm forward + backward through "
                  f"{way}: not run ({str(e).splitlines()[0][:200]})")
            continue
        print(f"[{card}] train path, BatchNorm forward + backward through {way}: "
              f"{float(np.median(times)):.4f} ms per step's {len(cases)} (median of sessions "
              f"{[round(t, 4) for t in times]}); forward max_abs_err vs the port's "
              f"{err:.3e}; costliest operations (ms per call): "
              f"{[(round(t, 4), n) for t, n in top]}")


def _steady_steps(card: str, path: str, what: str, batch: int, loader, step, prep,
                  loss_fn, opt, gen, lost, rate_steps: int = RATE_STEPS,
                  sync_steps: int = SYNC_STEPS, whole_reps: int = 5, split: bool = True,
                  prep_name: str = "augment", split_reps: int = 0):
    """A train path's step at full width, from the trained model:
    step(images, targets) -> loss (prep and the optimizer inside),
    prep(gen, images, targets) -> (x, y), loss_fn(x, y) -> the loss of a
    training-mode forward.  Warms up, reads the step rate by host clock
    over rate_steps steps, runs gate 6 (sync_steps steps under
    set_sync_debug_mode("error")) and the whole step's device time over
    whole_reps steps a session, with split its device time split (loss_fn
    and opt are used only there; prep is read as `prep_name`; split_reps,
    when set, is every part's calls a session), a reading: each part
    prints its sessions
    and its costliest device operations, and `lost(reps)` records may go
    missing a session without failing it.  Returns (gate 6's fault or
    None, to raise at the end of the path, so after the measurements; the
    split's prepared batch; the step's device ms; its host-clock
    seconds)."""

    def epochs():
        while True:
            yield from loader

    next_batch = functools.partial(next, epochs())
    for _ in range(3):  # warm-up: the optimizer's state, cuDNN plans
        step(*next_batch())
    torch.cuda.synchronize()
    loss_acc = torch.zeros((), device="cuda")
    with host_clock():
        t0 = time.perf_counter()
        for _ in range(rate_steps):
            loss_acc += step(*next_batch())
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / rate_steps
    if not math.isfinite(loss_acc.item()):
        fail(f"{path}: a step's loss is not finite")
    print(f"[{card}] {path}, {what}: {batch / step_s:.1f} img/s ({step_s * 1e3:.3f} "
          f"ms/step, host clock over {rate_steps} steps from the device-cached "
          f"loader, ending in a synchronize)")

    sync_fault = None
    for _ in range(sync_steps):
        imgs, targets = next_batch()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss_acc += step(imgs, targets)
        except RuntimeError:
            sync_fault = traceback.format_exc()
            break
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if sync_steps and sync_fault is None:
        print(f"[{card}] {path}: {sync_steps} steps ({prep_name} -> forward -> backward "
              f"-> clip -> AdamW, loss accumulated on the card) ran under "
              f"set_sync_debug_mode('error') without a synchronization")

    imgs, targets = next_batch()
    xb, yb = prep(gen, imgs, targets)

    def forward_backward():
        opt.zero_grad(set_to_none=True)
        loss_fn(xb, yb).backward()

    parts = {"whole step": (lambda: step(imgs, targets), whole_reps)}
    if split:
        parts.update({prep_name: (lambda: prep(gen, imgs, targets), split_reps or 10),
                      "forward with loss": (lambda: loss_fn(xb, yb), split_reps or 5),
                      "forward + backward": (forward_backward, split_reps or 5),
                      "clip + AdamW": (opt.step, split_reps or 10)})
    ms = {}
    for part, (fn, reps) in parts.items():
        times, top = session_times(fn, reps, what=f"{what}, {part}", lost=lost(reps))
        ms[part] = float(np.median(times))
        print(f"[{card}] {path}, device time of {part}: {ms[part]:.4f} ms "
              f"(median of sessions {[round(t, 4) for t in times]}); costliest "
              f"operations (ms per call): {[(round(t, 4), n) for t, n in top]}")
    ops = [sum(e.count for e in events)
           for events in _sessions(lambda: step(imgs, targets), 1)]
    whole_ms = ms["whole step"]
    print(f"[{card}] {path}, {what}: device time {whole_ms:.4f} ms against "
          f"{step_s * 1e3:.3f} ms of host clock, so the card idles "
          f"{1.0 - whole_ms / (step_s * 1e3):.1%} of the step; device operations per "
          f"step {ops} ({PROFILE_SESSIONS} sessions of one step)")
    if split:
        fb_ms = ms["forward + backward"]
        print(f"[{card}] {path}, device time split (profiler, median of "
              f"{PROFILE_SESSIONS} sessions): {prep_name} {ms[prep_name]:.4f} ms, "
              f"forward with loss {ms['forward with loss']:.4f} ms, backward "
              f"{fb_ms - ms['forward with loss']:.4f} ms (forward + backward "
              f"{fb_ms:.4f}), clip + AdamW {ms['clip + AdamW']:.4f} ms; sum "
              f"{ms[prep_name] + fb_ms + ms['clip + AdamW']:.4f} vs the whole "
              f"step {whole_ms:.4f}")
    return sync_fault, xb, whole_ms, step_s


def run_train_path(card: str):
    """`medseg train ResNet18` at full width, bf16, 256px; returns the
    launches of the 3-epoch run."""
    from medseg_tpu_torch.core.config import AugmentConfig, EvalConfig, TrainConfig
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.synthetic import synthetic_cls
    from medseg_tpu_torch.eval.harness import evaluate_model, load_model_bundle
    from medseg_tpu_torch.models.resnet import resnet18
    from medseg_tpu_torch.ops.augment import augment_batch
    from medseg_tpu_torch.train import losses as L
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train import train_model
    from medseg_tpu_torch.train.freeze import all_trainable, set_trainable

    ds = synthetic_cls(n=TRAIN_SAMPLES + VAL_SAMPLES, img_size=SIZE, seed=SEED)
    train_loader = BatchLoader(ds, BATCH, shuffle=True, seed=SEED,
                               indices=np.arange(TRAIN_SAMPLES), device_cache=True)
    val_loader = BatchLoader(ds, BATCH, shuffle=False, device_cache=True,
                             indices=np.arange(TRAIN_SAMPLES, TRAIN_SAMPLES + VAL_SAMPLES))
    n_steps, n_val = len(train_loader), len(val_loader)
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        cfg = dict(stage1_epochs=1, compute_dtype="bfloat16", save_root=tmp)
        logs = []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = train_model("ResNet18", train_loader, val_loader,
                          TrainConfig(epochs=TRAIN_EPOCHS, **cfg), AugmentConfig(),
                          save=True, log=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts("train path", {
            "warp_affine": TRAIN_EPOCHS * n_steps,
            "fused_photometric": TRAIN_EPOCHS * n_val})
        for line in logs:
            print(f"  {line.strip()}")
        rows = _epoch_lines(logs, "train path")
        stages = [any(f"STAGE {k}" in line for line in logs) for k in (1, 2)]
        if [r[0] for r in rows] != [1, 2, 3] or not all(stages):
            fail(f"train path: expected STAGE 1, STAGE 2 and epochs 1-3: {logs}")
        logs2 = []
        train_model("ResNet18", train_loader, val_loader,
                    TrainConfig(epochs=TRAIN_EPOCHS + 1, **cfg), AugmentConfig(),
                    save=True, resume=True, log=logs2.append)
        rows2 = _epoch_lines(logs2, "train path resume")
        if ([r[0] for r in rows2] != [TRAIN_EPOCHS + 1]
                or f"Resumed ResNet18 from epoch {TRAIN_EPOCHS}" not in "\n".join(logs2)):
            fail(f"train path: the resume did not run epoch {TRAIN_EPOCHS + 1} "
                 f"alone: {logs2}")
        print(f"  {logs2[0].strip()}\n  {logs2[1].strip()}")

        bundle = load_model_bundle("ResNet18", tmp, seg=False)
        if bundle is None:
            fail(f"train path: no best checkpoint was written: {logs}")
        resnet18().load_state_dict(bundle[0], strict=True)
        ev = evaluate_model("ResNet18", val_loader, None,
                            EvalConfig(weights_root=tmp), log=lambda *_: None)
        if ev["confusion_matrix"].sum() != VAL_SAMPLES:
            fail(f"train path: the best checkpoint's eval counts "
                 f"{ev['confusion_matrix'].sum()} samples")
    print(f"[{card}] train path, ResNet18 bf16 B={BATCH} at {SIZE}px, {TRAIN_EPOCHS} "
          f"epochs of {n_steps} steps + {n_val} validation batches (seed {SEED}): "
          f"{wall:.3f} s (host clock, model init, checkpoints and the first "
          f"steps' cuDNN plans included); the best checkpoint loads strictly "
          f"and evaluates to {ev['accuracy']:.2f}% on the validation split")

    # the trained weights and one batch augmented once, for gates 4 and 5 at
    # the end of the path
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    images, labels = next(iter(val_loader))
    x, _ = augment_batch(gen, images[:PARITY_BATCH].contiguous())
    parity = ({k: v.cpu() for k, v in res.model.state_dict().items()}, x.cpu(),
              labels[:PARITY_BATCH].cpu())

    # the stage-2 step at full width: rate, synchronization, device time
    model = res.model.train()
    opt = S.build_optimizer(1e-6, 5e-4, 1.0, set_trainable(model, all_trainable))

    def prep(g, imgs, targets):
        return augment_batch(g, imgs, out_dtype=torch.bfloat16)[0], targets

    sync_fault, xb, _, _ = _steady_steps(
        card, "train path", f"stage-2 step ResNet18 bf16 B={BATCH} at {SIZE}px", BATCH,
        train_loader, lambda imgs, t: S.cls_train_step(model, opt, imgs, t, gen, 0.1, prep)[0],
        prep, lambda x, y: L.cross_entropy(model(x, generator=gen), y, 0.1), opt, gen,
        lost=lambda reps: 1)
    _batch_norm_reading(card, model, xb, gen)
    _cls_parity(card, *parity)
    if sync_fault is not None:
        fail(f"train path: a train step synchronized with the host:\n{sync_fault}")
    return launches


UNET_ENCODER = tuple(f"encoder{i}" for i in range(1, 6))


def _is_encoder(name: str) -> bool:
    return name.split(".", 1)[0] in UNET_ENCODER


def _check_frozen_encoder(card: str, model, init: dict) -> None:
    """The frozen-encoder gate: every encoder parameter bit for bit its
    initial value, every encoder running statistic moved (its BatchNorms
    ran in training mode), every decoder weight moved."""
    got = model.state_dict()
    params = [n for n, _ in model.named_parameters()]
    encoder = [n for n in params if _is_encoder(n)]
    stats = [k for k in got if _is_encoder(k) and k.endswith(("running_mean", "running_var"))]
    weights = [n for n in params if not _is_encoder(n) and n.endswith("weight")]
    biases = [n for n in params if not _is_encoder(n) and n.endswith("bias")]
    moved = [n for n in encoder if not torch.equal(got[n], init[n])]
    still = [k for k in stats + weights if torch.equal(got[k], init[k])]
    if moved or still:
        fail(f"seg path: encoder parameters that moved {moved}; running statistics "
             f"or decoder weights that did not {still}")
    n_bias = sum(not torch.equal(got[n], init[n]) for n in biases)
    print(f"[{card}] seg path: the {len(encoder)} encoder parameters are bit for bit "
          f"their initial values; all {len(stats)} encoder running statistics and "
          f"all {len(weights)} decoder weights moved ({n_bias} of {len(biases)} "
          f"decoder biases)")


def _seg_recipe(name: str, state: dict):
    """Gate 4's (build, step, loss64) for ResNetUnet from `state`: the
    encoder frozen, BCE with logits (see _check_card_against_cpu)."""
    import torch.nn.functional as F

    from medseg_tpu_torch.models.resnet_unet import resnet_unet
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable

    def build(device, dtype):
        model = resnet_unet(dtype=dtype, device=device)
        model.load_state_dict(state, strict=True)
        if dtype == torch.float64:
            model.double()
        return model, S.build_optimizer(
            PARITY_LR, 5e-4, 1.0, set_trainable(model.train(), finetune_filter(name)))

    def loss64(model, x, y):
        out = model(x)
        t = y.to(out.dtype)
        return -(t * F.logsigmoid(out) + (1.0 - t) * F.logsigmoid(-out)).mean()

    return build, S.seg_train_step, loss64


def _seg_parity(card: str, state: dict, images, masks):
    """Gates 4 and 5 of the seg path: ResNetUnet with the encoder frozen,
    BCE with logits; the CPU half in the CPU worker."""
    _check_card_against_cpu(
        card, "seg path", f"ResNetUnet B={SEG_PARITY_BATCH} at {SIZE}px, encoder frozen",
        *_seg_recipe("ResNetUnet", state), images, masks,
        recipe=("seg", "ResNetUnet", state))


def _mask_gate(card: str, ds) -> None:
    """The card's fused branch of augment_batch (the mask as B1's 4th plane,
    warped bilinearly and thresholded) against the CPU branch (true
    nearest) on one synthetic_seg batch, both fed the same AugmentParams:
    the images within B1's float32 tolerance, and every mask pixel where
    the two differ on a region edge of the CPU mask (a 4-neighbour holds
    the other value), ops/augment.py's documented difference."""
    from medseg_tpu_torch.core.config import AugmentConfig
    from medseg_tpu_torch.ops import augment as A

    images = torch.from_numpy(ds.images[:SEG_BATCH])
    masks = torch.from_numpy(ds.masks[:SEG_BATCH])
    params = A.sample_augment_params(torch.Generator().manual_seed(SEED + 5), SEG_BATCH,
                                     AugmentConfig())
    sampler = A.sample_augment_params
    A.sample_augment_params = lambda gen, b, cfg: params
    try:
        x_card, m_card = A.augment_batch(torch.Generator(device="cuda"), images.cuda(),
                                         masks.cuda())
        x_cpu, m_cpu = A.augment_batch(torch.Generator(), images, masks)
    finally:
        A.sample_augment_params = sampler
    err = (x_card.cpu() - x_cpu).abs().max().item()
    card_m, cpu_m = m_card.cpu()[..., 0] > 0.5, m_cpu[..., 0] > 0.5
    edge = torch.zeros_like(cpu_m)
    for dim in (1, 2):
        step = cpu_m.narrow(dim, 1, SIZE - 1) != cpu_m.narrow(dim, 0, SIZE - 1)
        edge.narrow(dim, 1, SIZE - 1).logical_or_(step)
        edge.narrow(dim, 0, SIZE - 1).logical_or_(step)
    differ = card_m != cpu_m
    inner = int((differ & ~edge).sum())
    print(f"[{card}] seg path, mask gate (B={SEG_BATCH} at {SIZE}px, one injected "
          f"AugmentParams draw, {int(params.flip.sum())} flips, {int((params.scale != 1).sum())} "
          f"warps): images card vs CPU branch max_abs_err={err:.3e} tol 1e-3; masks "
          f"differ on {int(differ.sum())} of {differ.numel()} pixels "
          f"({float(differ.float().mean()):.4%}; {int(edge.sum())} pixels lie on a "
          f"region edge of the CPU mask), {inner} of them off an edge (tol 0)")
    if not err <= 1e-3 or inner:
        fail(f"seg path: the card's fused augmentation differs from the CPU branch "
             f"(images {err}, {inner} mask pixels off a region edge)")


def _family_reading(card: str, path: str, model, x, step_ms: float, families: dict):
    """A reading that gates nothing: each module family's device time in a
    train step at the step's shapes, replayed from inputs captured in one
    train-mode forward: forward and backward where the step runs one (a
    trainable parameter or an input that carries a gradient), forward only
    elsewhere (the frozen encoder's BatchNorms)."""
    captured = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: captured.append((m, args[0].detach(), args[0].requires_grad)))
        for m in model.modules() if isinstance(m, tuple(families.values()))]
    model(x)
    for h in hooks:
        h.remove()
    for label, kind in families.items():
        cases = []
        for m, xi, needs_grad in (c for c in captured if isinstance(c[0], kind)):
            wrt = ([xi.requires_grad_()] if needs_grad else []) + [
                p for p in m.parameters() if p.requires_grad]
            with torch.no_grad():
                gy = torch.randn_like(m(xi)) if wrt else None
            cases.append((m, xi, wrt, gy))

        def run(cases=cases):
            for m, xi, wrt, gy in cases:
                if wrt:
                    torch.autograd.grad(m(xi), wrt, gy)
                else:
                    with torch.no_grad():
                        m(xi)

        times, top = session_times(run, 5, what=label, lost=5)
        ms = float(np.median(times))
        n_bwd = sum(c[2] != [] for c in cases)
        print(f"[{card}] {path}, {label}: {len(cases)} modules ({n_bwd} with a backward), "
              f"{ms:.4f} ms of device time per step ({ms / step_ms:.1%} of the device "
              f"step; median of sessions {[round(t, 4) for t in times]}); costliest "
              f"operations (ms per call): {[(round(t, 4), n) for t, n in top]}")


def conv_flops(model, x, **kw) -> dict:
    """The operations of the convs and transposed convs in one forward of
    model(x, **kw), from their shapes (2 per multiply-add), split into the
    encoder's and the rest."""
    flops = {"encoder": 0, "decoder": 0}

    def count(name):
        def hook(m, args, out):
            taps = m.kernel_size[0] * m.kernel_size[1]
            if isinstance(m, torch.nn.ConvTranspose2d):
                macs = args[0].numel() * m.out_channels * taps
            else:
                macs = out.numel() * m.in_channels // m.groups * taps
            flops["encoder" if _is_encoder(name) else "decoder"] += 2 * macs
        return hook

    hooks = [m.register_forward_hook(count(n)) for n, m in model.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.no_grad():
        model(x, **kw)
    for h in hooks:
        h.remove()
    return flops


def _warp_c4_reading(card: str) -> None:
    """B1's segmentation form (C=4: the mask as a 4th plane with mean 0, std
    1; float32 out) at the seg step's B=8 and the seg_e2e reading's B=128:
    against its plain version (tolerance 0: same float32 operation order,
    no FMA), and its device time beside the plain version's and its bound."""
    from medseg_tpu_torch.core.config import AugmentConfig, IMAGENET_MEAN, IMAGENET_STD
    from medseg_tpu_torch.ops.augment import _combined_matrices, sample_augment_params
    from medseg_tpu_torch.ops.kernels.warp_kernel import warp_affine_kernel
    from medseg_tpu_torch.ops.warp_fast import warp_affine_fast

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for b, reps in ((SEG_BATCH, 50), (BATCH, 20)):
        imgs = torch.randint(0, 256, (b, SIZE, SIZE, 4), generator=gen, device="cuda",
                             dtype=torch.uint8)
        p = sample_augment_params(gen, b, AugmentConfig())
        mats = _combined_matrices(p, SIZE, SIZE)
        kw = dict(alpha=p.alpha, beta=p.beta,
                  mean=tuple(m * 255.0 for m in IMAGENET_MEAN) + (0.0,),
                  std=tuple(s * 255.0 for s in IMAGENET_STD) + (1.0,))
        err = (warp_affine_kernel(imgs, mats, **kw)
               - warp_affine_fast(imgs, mats, **kw)).abs().max().item()
        if err != 0.0:
            fail(f"warp kernel C=4 f32 B={b} disagrees with its plain version: {err}")
        ms = device_ms(lambda: warp_affine_kernel(imgs, mats, **kw), reps,
                       "warp_affine_kernel<")
        plain_ms = device_ms(lambda: warp_affine_fast(imgs, mats, **kw), 5)
        b_ms, b_by = warp_bound_ms(b, SIZE, SIZE, 4, 4)
        print(f"[{card}] seg path, warp kernel B={b} {SIZE}x{SIZE}x4 u8->f32 with "
              f"epilogue (mask plane mean 0 std 1): max_abs_err={err} tol 0; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms:.0%} of it")


@_on_host_clock
def _seg_e2e_reading(card: str, state: dict) -> None:
    """A reading that gates nothing but its launch count and output: the
    JAX bench's seg_e2e program (4-plane augment_batch -> ResNetUnet bf16
    -> sigmoid > 0.5) at B=128 over SEG_E2E_BATCHES batches of the
    device-cached loader, with the seg path's trained weights, by host
    clock and by device time."""
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.synthetic import synthetic_seg
    from medseg_tpu_torch.models.resnet_unet import resnet_unet
    from medseg_tpu_torch.ops.augment import augment_batch

    ds = synthetic_seg(n=BATCH * SEG_E2E_BATCHES, img_size=SIZE, seed=SEED + 4)
    loader = BatchLoader(ds, BATCH, shuffle=True, seed=SEED, drop_last=True,
                         device_cache=True)
    model = resnet_unet(dtype=torch.bfloat16)
    model.load_state_dict(state, strict=True)
    model.eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def step(images, masks):
        x, m = augment_batch(gen, images, masks, out_dtype=torch.bfloat16)
        return torch.sigmoid(model(x)) > 0.5, m

    with torch.inference_mode():
        images, masks = next(iter(loader))  # warm-up: cuDNN plans, allocator
        step(images, masks)
        torch.cuda.synchronize()
        reset_counts()
        preds = []
        t0 = time.perf_counter()
        for images, masks in loader:
            preds.append(step(images, masks)[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        read_counts("seg_e2e reading", {"warp_affine": len(loader)})
        x, _ = augment_batch(gen, images, masks, out_dtype=torch.bfloat16)
        logits = model(x)
        if (preds[-1].shape != (BATCH, SIZE, SIZE, 1) or logits.dtype != torch.float32
                or not torch.isfinite(logits).all()):
            fail(f"seg_e2e: bad output {tuple(preds[-1].shape)} {logits.dtype}")
        dev_ms = device_ms(lambda: step(images, masks), 3)
        flops = sum(conv_flops(model, x).values())
    host_ms = wall / len(loader) * 1e3
    rate = flops / dev_ms / 1e9
    print(f"[{card}] seg_e2e reading, 4-plane augment_batch + ResNetUnet bf16 + "
          f"sigmoid > 0.5, B={BATCH} at {SIZE}px, {len(loader)} batches: "
          f"{BATCH / host_ms * 1e3:.1f} img/s ({host_ms:.3f} ms/batch, host clock "
          f"ending in a synchronize); device time {dev_ms:.4f} ms/batch, so the card "
          f"idles {1 - dev_ms / host_ms:.1%}; the convs' {flops / 1e12:.3f} TFLOP a "
          f"batch at {rate:.1f} TFLOP/s, {rate * 1e12 / BF16_FLOPS_PER_S:.1%} of the "
          f"bf16 peak; foreground share {float(torch.cat(preds).float().mean()):.4f}")


def run_seg_path(card: str):
    """`medseg train ResNetUnet` at full width (ResNet50 encoder, five
    ConvTranspose decoder stages), bf16, 256px, B=8: 3 epochs and a resume,
    the best checkpoint through the seg eval harness, then the gates and
    readings of run_train_path for the seg step; returns the launches of
    the 3-epoch run."""
    from medseg_tpu_torch.core.config import AugmentConfig, EvalConfig, TrainConfig
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.synthetic import synthetic_seg
    from medseg_tpu_torch.eval.csv_io import save_results_to_csv
    from medseg_tpu_torch.eval.harness import (load_model_bundle, print_summary,
                                               test_all_models)
    from medseg_tpu_torch.models.resnet_unet import resnet_unet
    from medseg_tpu_torch.nn.blocks import BatchNorm2d, ConvTranspose2d
    from medseg_tpu_torch.ops.augment import augment_batch
    from medseg_tpu_torch.train import losses as L
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train import train_model
    from medseg_tpu_torch.train import trainer as T
    from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable

    dev = torch.device("cuda")
    ds = synthetic_seg(n=SEG_TRAIN + SEG_VAL, img_size=SIZE, seed=SEED)
    val_idx = np.arange(SEG_TRAIN, SEG_TRAIN + SEG_VAL)
    train_loader = BatchLoader(ds, SEG_BATCH, shuffle=True, seed=SEED,
                               indices=np.arange(SEG_TRAIN), device_cache=True)
    val_loader = BatchLoader(ds, SEG_BATCH, shuffle=False, indices=val_idx,
                             device_cache=True)
    n_steps, n_val = len(train_loader), len(val_loader)
    # the trainer's initial weights, drawn again from its generator for SEED
    init = resnet_unet(dtype=torch.bfloat16)
    T.init_weights(init, T._generator(dev, SEED, T._INIT))
    init = {k: v.clone() for k, v in init.state_dict().items()}
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        # lr 1e-4: the recipe's 1e-6 moves the decoder little in 48 steps
        cfg = dict(compute_dtype="bfloat16", save_root=tmp, lr=1e-4)
        logs = []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = train_model("ResNetUnet", train_loader, val_loader,
                          TrainConfig(epochs=SEG_EPOCHS, **cfg), AugmentConfig(),
                          seed=SEED, save=True, log=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts("seg path", {"warp_affine": SEG_EPOCHS * n_steps,
                                            "fused_photometric": SEG_EPOCHS * n_val})
        for line in logs:
            print(f"  {line.strip()}")
        rows = _epoch_lines(logs, "seg path", SEG_EPOCH_LINE)
        if ([r[0] for r in rows] != list(range(1, SEG_EPOCHS + 1))
                or not logs[0].startswith("Training Segmentation model")):
            fail(f"seg path: expected the segmentation line and epochs 1-{SEG_EPOCHS}: {logs}")
        _check_frozen_encoder(card, res.model, init)
        logs2 = []
        train_model("ResNetUnet", train_loader, val_loader,
                    TrainConfig(epochs=SEG_EPOCHS + 1, **cfg), AugmentConfig(),
                    seed=SEED, save=True, resume=True, log=logs2.append)
        rows2 = _epoch_lines(logs2, "seg path resume", SEG_EPOCH_LINE)
        if ([r[0] for r in rows2] != [SEG_EPOCHS + 1]
                or f"Resumed ResNetUnet from epoch {SEG_EPOCHS}" not in "\n".join(logs2)):
            fail(f"seg path: the resume did not run epoch {SEG_EPOCHS + 1} alone: {logs2}")
        print("\n".join(f"  {line.strip()}" for line in logs2[:3]))

        # the best checkpoint through `medseg eval`'s segmentation branch
        bundle = load_model_bundle("ResNetUnet", tmp, seg=True)
        if bundle is None:
            fail(f"seg path: no best checkpoint was written: {logs}")
        resnet_unet().load_state_dict(bundle[0], strict=True)
        eval_loader = BatchLoader(ds, EVAL_BATCH, shuffle=False, indices=val_idx)
        elogs = []
        torch.cuda.synchronize()
        reset_counts()
        results = test_all_models(None, eval_loader, EvalConfig(weights_root=tmp),
                                  log=elogs.append)
        torch.cuda.synchronize()
        read_counts("seg eval", {"fused_photometric": len(eval_loader)})
        skipped = [m for m in ("AttentionUNet", "R2Unet", "R2AttUnet", "CLIPSeg")
                   if f"\n[WARNING] Weights not found for {m}" in elogs]
        if list(results) != ["ResNetUnet"] or len(skipped) != 4:
            fail(f"seg eval: results for {list(results)}, skipped {skipped}; log {elogs}")
        res_eval = results["ResNetUnet"]
        if not all(0.0 <= v <= 100.0 for v in res_eval.values()):
            fail(f"seg eval: metrics out of range: {res_eval}")
        print_summary(results)
        seg_csv = Path(tmp) / "results" / "segmentation_test_results.csv"
        save_results_to_csv(results, str(Path(tmp) / "results" / "classification.csv"),
                            str(seg_csv), log=lambda *_: None)
        with open(seg_csv, newline="") as f:
            csv_rows = list(csv.DictReader(f))
        if (len(csv_rows) != 1 or csv_rows[0].pop("Model") != "ResNetUnet"
                or {k: float(v) for k, v in csv_rows[0].items()} != res_eval):
            fail(f"seg eval: the CSV reads back as {csv_rows}, not {res_eval}")
    print(f"[{card}] seg path, ResNetUnet bf16 B={SEG_BATCH} at {SIZE}px, {SEG_EPOCHS} "
          f"epochs of {n_steps} steps + {n_val} validation batches (seed {SEED}): "
          f"{wall:.3f} s (host clock, checkpoints and the first steps' cuDNN plans "
          f"included); the best checkpoint loads strictly and the seg harness, "
          f"{len(eval_loader)} batches of {EVAL_BATCH} with one photometric launch "
          f"each, gives IoU {res_eval['iou']:.2f}%, Dice {res_eval['dice']:.2f}%; the "
          f"CSV reads back to the metrics")

    trained = {k: v.cpu() for k, v in res.model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    images, masks = next(iter(val_loader))
    x, m = augment_batch(gen, images[:SEG_PARITY_BATCH].contiguous(),
                         masks[:SEG_PARITY_BATCH].contiguous())
    _seg_parity(card, trained, x.cpu(), m.cpu())  # the CPU half runs in the worker

    # the seg step at full width: rate, synchronization, device time
    model = res.model.train()
    opt = S.build_optimizer(1e-6, 5e-4, 1.0, set_trainable(model, finetune_filter("ResNetUnet")))

    def prep(g, imgs, targets):
        return augment_batch(g, imgs, targets, out_dtype=torch.bfloat16)

    # a session of seg steps (~1060 device operations each) may lose a
    # record per step: sessions of 10 steps counted 10589, 10590 and 10588
    sync_fault, xb, whole_ms, step_s = _steady_steps(
        card, "seg path", f"seg step ResNetUnet bf16 B={SEG_BATCH} at {SIZE}px", SEG_BATCH,
        train_loader, lambda imgs, t: S.seg_train_step(model, opt, imgs, t, gen, prep),
        prep, lambda x, y: L.bce_with_logits(model(x), y), opt, gen, lost=lambda reps: reps)
    flops = conv_flops(model, xb)
    # the forward's convs, and the decoder's twice more in the backward
    # (gradients of inputs and of weights); the frozen encoder has none
    step_flops = flops["encoder"] + 3 * flops["decoder"]
    rate = step_flops / whole_ms / 1e9
    print(f"[{card}] seg path, the convs' {step_flops / 1e12:.3f} TFLOP a step "
          f"(forward: encoder {flops['encoder'] / 1e9:.1f}, decoder "
          f"{flops['decoder'] / 1e9:.1f} GFLOP) at {rate:.1f} TFLOP/s of device time, "
          f"{rate * 1e12 / BF16_FLOPS_PER_S:.1%} of the bf16 peak; the card idles "
          f"{1.0 - whole_ms / (step_s * 1e3):.1%} of the host-clock step")
    _family_reading(card, "seg path", model, xb, whole_ms,
                    {"the 5 ConvTranspose layers": ConvTranspose2d,
                     "the BatchNorms": BatchNorm2d})
    _warp_c4_reading(card)
    _seg_e2e_reading(card, trained)
    _mask_gate(card, ds)
    if sync_fault is not None:
        fail(f"seg path: a seg step synchronized with the host:\n{sync_fault}")
    return launches


def _xray_like(rng, h: int, w: int) -> np.ndarray:
    """A gray RGB uint8 image of an X-ray's texture: a smooth vertical and
    radial ramp with noise (sd 8), the same value in the three planes."""
    y, x = np.mgrid[0:h, 0:w]
    r = np.hypot((y - h / 2) / h, (x - w / 2) / w)
    base = 60.0 + 120.0 * y / h + 60.0 * np.cos(6.0 * r)
    gray = np.clip(base + rng.normal(0, 8, (h, w)), 0, 255).astype(np.uint8)
    return np.repeat(gray[..., None], 3, axis=-1)


def _serve_weights(card: str, base: Path, probe: torch.Tensor) -> dict:
    """ResNet18 and ResNetUnet, float32, init_weights from SEED and random
    BatchNorm statistics, written as the reference's .pt under two weights
    roots: one whose classifier head is biased to COVID, one to Healthy
    (4x the largest |logit| of `probe`, a uint8 grid batch, + 10).  The
    ResNetUnet file is written once and linked into the second root."""
    from medseg_tpu_torch.models.resnet import init_weights, resnet18
    from medseg_tpu_torch.models.resnet_unet import resnet_unet
    from medseg_tpu_torch.ops.augment import preprocess_eval_batch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cls, unet = resnet18(), resnet_unet()
    for model in (cls, unet):
        init_weights(model, gen)
        randomize_bn_stats(model, gen)
    with torch.inference_mode():
        spread = cls.eval()(preprocess_eval_batch(probe)[0]).abs().max().item()
    cls_sd = {k: v.cpu() for k, v in cls.state_dict().items()}
    roots = {}
    for verdict, winner in (("COVID", 0), ("Healthy", 1)):
        root = roots[verdict] = base / verdict
        (root / "classification_models").mkdir(parents=True)
        (root / "segmentation_models").mkdir(parents=True)
        bias = torch.zeros(3)
        bias[winner] = 4.0 * spread + 10.0
        torch.save(dict(cls_sd, **{"fc.1.bias": bias}),
                   root / "classification_models" / "ResNet18_best_acc.pt")
    seg_files = [r / "segmentation_models" / "ResNetUnet_best_loss.pt" for r in roots.values()]
    torch.save({k: v.cpu() for k, v in unet.state_dict().items()}, seg_files[0])
    os.link(seg_files[0], seg_files[1])
    print(f"[{card}] serve path weights: ResNet18 and ResNetUnet float32 "
          f"(init_weights, seed {SEED}, random BN statistics); the head bias "
          f"{4.0 * spread + 10.0:.3f} forces COVID or Healthy")
    return roots


def _post(port: int, body: bytes, timeout: float = 120.0) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _burst(port: int, bodies) -> list:
    """POST every body at once, one thread each; the responses in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(bodies)) as pool:
        return list(pool.map(lambda b: _post(port, b), bodies))


def _card_against_cpu(card: str, pipe, cpu_pipe, arrays, seg_name: str = "ResNetUnet",
                      path: str = "serve path") -> None:
    """Gate 2: the same images and .pt through the port's Pipeline on the
    card (TF32 off) and on the CPU, one process_batch each, its forwards'
    outputs recorded on the way."""
    from medseg_tpu_torch.infer.overlay import resize_mask_nearest

    def run(p):
        outs = []
        forward = p._forward

        def record(fn, grid):
            outs.append(forward(fn, grid))
            return outs[-1]

        p._forward = record
        try:
            results = p.process_batch(arrays, seg_name)
        finally:
            del p._forward
        if len(outs) != 2:
            fail(f"{path} gate 2: process_batch ran {len(outs)} forwards, not 2")
        return results, outs[0], outs[1][..., 0]

    card_res, logits, probs = run(pipe)
    cpu_res, logits_cpu, probs_cpu = run(cpu_pipe)
    classes = [r[0] for r in card_res]
    logit_err = np.abs(logits - logits_cpu).max()
    logit_tol = 1e-3 * max(1.0, np.abs(logits_cpu).max())
    prob_err = np.abs(probs - probs_cpu).max()
    mask, mask_cpu = probs > 0.5, probs_cpu > 0.5
    differ = mask != mask_cpu
    near = np.abs(probs_cpu - 0.5) <= 1e-3
    overlay_ok = True
    for j, (a, b) in enumerate(zip(card_res, cpu_res)):
        h, w = arrays[j].shape[:2]
        agree = resize_mask_nearest(~differ[j], h, w)
        overlay_ok &= a[2] is not None and b[2] is not None and bool(
            np.array_equal(a[2][agree], b[2][agree]))
    print(f"[{card}] {path} gate 2, {len(arrays)} images through Pipeline "
          f"({pipe._cls[0]} + {seg_name}) on the card (TF32 off) and on the CPU: "
          f"classes {classes} vs "
          f"{[r[0] for r in cpu_res]}; logits max_abs_err={logit_err:.3e} "
          f"tol={logit_tol:.3e}; seg probabilities max_abs_err={prob_err:.3e} tol=1e-3; "
          f"{int(differ.sum())} of {differ.size} mask pixels differ, all within 1e-3 of "
          f"the threshold: {bool(near[differ].all())}; overlays equal where the masks "
          f"agree: {overlay_ok}; mask share {mask.mean():.3f}")
    if (classes != [r[0] for r in cpu_res] or not logit_err <= logit_tol
            or not prob_err <= 1e-3 or not near[differ].all() or not overlay_ok):
        fail(f"{path} gate 2: the card's Pipeline disagrees with the CPU's")


@_on_host_clock
def _device_split(card: str, pipe, arrays, host_group_ms: float) -> None:
    """A reading: the device time of one B=8 COVID group (process_batch)
    and of its parts, beside the host-clock group time."""
    from medseg_tpu_torch.ops.augment import preprocess_eval_batch

    grid = pipe._grid_batch(arrays, SIZE, pipe.device)
    x, _ = preprocess_eval_batch(grid)

    def forward(entry):
        def run():
            with torch.inference_mode():
                entry[1].model(x)
        return run

    parts = {"group": ("the whole group (process_batch)",
                       lambda: pipe.process_batch(arrays, "ResNetUnet"), 3),
             "resize": (f"the {len(arrays)} per-image copies and resizes (_grid_batch)",
                        lambda: pipe._grid_batch(arrays, SIZE, pipe.device), 5),
             "b2": ("B2, one forward's", lambda: preprocess_eval_batch(grid), 20),
             "cls": ("the ResNet18 float32 forward", forward(pipe._cls), 5),
             "seg": ("the ResNetUnet float32 forward", forward(pipe._seg), 3)}
    ms = {}
    for key, (what, fn, reps) in parts.items():
        times, top = session_times(fn, reps, what=what, lost=reps)
        ms[key] = float(np.median(times))
        print(f"[{card}] serve path, device time of {what}: {ms[key]:.4f} ms "
              f"(median of sessions {[round(t, 4) for t in times]}); costliest "
              f"operations (ms per call): {[(round(t, 4), n) for t, n in top[:3]]}")
    h, w = arrays[0].shape[:2]
    print(f"[{card}] serve path, one B={len(arrays)} COVID group of {w}x{h} images: "
          f"device {ms['group']:.4f} ms against {host_group_ms:.3f} ms of host clock, "
          f"so the card idles {1.0 - ms['group'] / host_group_ms:.1%} of the group; "
          f"parts: resizes {ms['resize']:.4f}, B2 x2 {2 * ms['b2']:.4f}, ResNet18 "
          f"{ms['cls']:.4f}, ResNetUnet {ms['seg']:.4f} ms (sum "
          f"{ms['resize'] + 2 * ms['b2'] + ms['cls'] + ms['seg']:.4f})")


def run_serve_path(card: str):
    """`medseg serve` and `medseg predict` at full width: ResNet18 +
    ResNetUnet float32 at 256px from the reference's .pt, behind
    InferenceServer over loopback, after warmup; the five gates and the
    readings of the module docstring."""
    from medseg_tpu_torch.core.config import EvalConfig
    from medseg_tpu_torch.infer.pipeline import Pipeline
    from medseg_tpu_torch.infer.server import InferenceServer, _encode_png

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    requests = [_xray_like(rng, h, w) for h, w in SERVE_SHAPES for _ in range(2)]
    bodies = [json.dumps({"image": _encode_png(a)}).encode()
              for a in requests]
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        probe = Pipeline._grid_batch(requests, SIZE, dev)
        roots = _serve_weights(card, Path(tmp), probe)
        servers, ports, httpds = {}, {}, []
        t0 = time.perf_counter()
        for verdict, root in roots.items():
            server = servers[verdict] = InferenceServer(EvalConfig(weights_root=str(root)))
            server.warmup(log=lambda *_: None)
            httpd, ports[verdict] = server.start_background()
            httpds.append(httpd)
        print(f"[{card}] serve path: two servers loaded and warmed up (B={SERVE_BATCHES}, "
              f"both forwards each, TF32 off) in {time.perf_counter() - t0:.3f} s")
        try:
            pipe = servers["COVID"].pipeline
            cpu_pipe = Pipeline(EvalConfig(weights_root=str(roots["COVID"])), device="cpu")
            cpu_pipe._load_models("ResNet18", "ResNetUnet")
            with servers["COVID"].lock:
                _card_against_cpu(card, pipe, cpu_pipe, requests)
            del cpu_pipe

            # PyTorch's default flags from here on: cuDNN may use TF32
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
            flag_text = ("PyTorch's default flags (cudnn.allow_tf32=True, "
                         "cuda.matmul.allow_tf32=False)")
            for server in servers.values():
                server.warmup(log=lambda *_: None)
            _serve_gates(card, servers, ports, requests, bodies)
            _serve_readings(card, servers["COVID"], ports["COVID"], requests, bodies,
                            flag_text)
            _predict_gate(card, roots, rng, flag_text)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
            for httpd in httpds:
                httpd.shutdown()
                httpd.server_close()


def _serve_gates(card: str, servers: dict, ports: dict, requests, bodies) -> None:
    """Gates 1, 3 and 4 on both servers: each request alone, then a burst of
    all 8 at once."""
    from medseg_tpu_torch.infer.server import _decode_image

    for verdict, server in servers.items():
        p = server.pipeline
        seen = (set(p._cls[1].seen_batches), set(p._seg[1].seen_batches))
        batches0 = server.stats["batches"]
        torch.cuda.synchronize()
        reset_counts()
        outs = [_post(ports[verdict], b) for b in bodies] + _burst(ports[verdict], bodies)
        groups = server.stats["batches"] - batches0
        per_group = 2 if verdict == "COVID" else 1
        got = read_counts(f"serve path, {verdict}-forced requests",
                          {"fused_photometric": per_group * groups})
        # gate 3: the burst met no new batch shape, and was micro-batched
        after = (p._cls[1].seen_batches, p._seg[1].seen_batches)
        if after != seen or server.stats["max_batch"] < 2:
            fail(f"serve path gate 3 ({verdict}): batch shapes {seen} -> {after}, "
                 f"max_batch {server.stats['max_batch']}")
        # gate 4: every overlay decodes to its request's H x W x 3
        for out, img in zip(outs, requests + requests):
            if out["prediction"] != verdict:
                fail(f"serve path: a {verdict}-forced request answered {out}")
            if verdict == "COVID":
                shape = _decode_image(out["overlay"]).shape
                if shape != img.shape:
                    fail(f"serve path gate 4: overlay {shape} for a {img.shape} request")
            elif out["overlay"] is not None:
                fail("serve path: a Healthy verdict came with an overlay")
        overlays = ("every overlay decodes to its request's shape" if verdict == "COVID"
                    else "no overlay")
        with urllib.request.urlopen(f"http://127.0.0.1:{ports[verdict]}/health",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        if health["models"] != {"classification": "ResNet18", "segmentation": "ResNetUnet"}:
            fail(f"serve path gate 4: /health says {health}")
        print(f"[{card}] serve path, {verdict}-forced server: {len(outs)} requests "
              f"({len(bodies)} one at a time, then a burst of {len(bodies)}) in "
              f"{groups} groups, largest {server.stats['max_batch']}; "
              f"photometric launches {got['fused_photometric']} = {per_group} a group; "
              f"the burst met no new batch shape ({sorted(s[0] for s in after[0])}); "
              f"{overlays}; /health names "
              f"{health['models']}")


@_on_host_clock
def _serve_readings(card: str, server, port: int, requests, bodies, flag_text: str) -> None:
    """Latency of single requests (p50, p99) and its host-clock split,
    bursts' throughput, the synchronizations of one group and the device
    split of one B=8 COVID group: readings, gating nothing."""
    import warnings

    from medseg_tpu_torch.infer.overlay import red_overlay
    from medseg_tpu_torch.infer.pipeline import Pipeline
    from medseg_tpu_torch.infer.server import _decode_image, _encode_png

    single = bodies[0]  # 299x299
    lat = []
    for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        _post(port, single)
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p90, p99 = np.percentile(lat, [50, 90, 99])
    print(f"[{card}] serve path, {SERVE_REQUESTS} sequential requests of one "
          f"{requests[0].shape[1]}x{requests[0].shape[0]} PNG (COVID-forced: classify, "
          f"segment, overlay), full HTTP round trip over loopback, host clock, "
          f"{flag_text}: p50 {p50:.3f} ms, p90 {p90:.3f} ms, p99 {p99:.3f} ms, "
          f"max {max(lat):.3f} ms")

    # the same request's stages, by host clock, each ending in its read or a
    # synchronize; medians of 20
    pipe, dev = server.pipeline, server.pipeline.device
    payload = json.loads(single)["image"]
    img = _decode_image(payload)
    stages = {}

    def stage(name, fn, reps=20):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        stages[name] = float(np.median(times))
        return out

    with server.lock:
        stage("decode (base64 + PNG, PIL)", lambda: _decode_image(payload))
        grid = stage("_to_grid (copy + resize)", lambda: Pipeline._to_grid(img[None], SIZE, dev))
        stage("classify (B2 + ResNet18 + read)", lambda: pipe._forward(pipe._cls[1], grid))
        probs = stage("segment (B2 + ResNetUnet + sigmoid + read)",
                      lambda: pipe._forward(pipe._seg[1], grid)[0, :, :, 0])
        mask = (probs > 0.5).astype(np.uint8) * 255
        stage("overlay + PNG encode + base64",
              lambda: _encode_png(red_overlay(img, mask)))
    print(f"[{card}] serve path, one request's stages by host clock (median of 20, "
          f"{flag_text}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.3f} ms against the round trip's p50 {p50:.3f}")

    walls = []
    for _ in range(SERVE_BURSTS):
        t0 = time.perf_counter()
        _burst(port, bodies)
        walls.append(time.perf_counter() - t0)
    print(f"[{card}] serve path, {SERVE_BURSTS} bursts of {len(bodies)} concurrent requests "
          f"(2 of each of {SERVE_SHAPES} (H, W)), host clock, {flag_text}: median "
          f"{np.median(walls) * 1e3:.3f} ms a burst (min {min(walls) * 1e3:.3f}, max "
          f"{max(walls) * 1e3:.3f}), {SERVE_BURSTS * len(bodies) / sum(walls):.1f} img/s; "
          f"{server.stats['batches']} groups so far, largest {server.stats['max_batch']}")

    group = [requests[0]] * Pipeline.MAX_BATCH  # eight 299x299 images
    with server.lock:
        host = []
        for _ in range(10):
            t0 = time.perf_counter()
            pipe.process_batch(group, "ResNetUnet")
            host.append((time.perf_counter() - t0) * 1e3)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                pipe.process_batch(group, "ResNetUnet")
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        print(f"[{card}] serve path, one B={len(group)} COVID group: {syncs} "
              f"synchronizations under set_sync_debug_mode('warn') (2 expected: one "
              f"read per forward); host clock median {np.median(host):.3f} ms over 10")
        _device_split(card, pipe, group, float(np.median(host)))


@_on_host_clock
def _predict_gate(card: str, roots: dict, rng, flag_text: str) -> None:
    """Gate 5: batch_predict over a directory of PREDICT_IMAGES PNGs at
    299x299 in batches of PREDICT_BATCH, with each weights root."""
    from medseg_tpu_torch.core.config import EvalConfig
    from medseg_tpu_torch.infer.batch import _write_png, batch_predict

    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        src = Path(tmp) / "images"
        src.mkdir()
        for i in range(PREDICT_IMAGES):
            _write_png(_xray_like(rng, 299, 299), src / f"xray{i:03d}.png")
        paths = sorted(str(p) for p in src.glob("*.png"))
        n_batches = -(-PREDICT_IMAGES // PREDICT_BATCH)
        for verdict, root in roots.items():
            out = Path(tmp) / verdict
            stamps = []
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            results = batch_predict(paths, cfg=EvalConfig(weights_root=str(root)),
                                    batch_size=PREDICT_BATCH, output_dir=str(out),
                                    log=lambda line: stamps.append(time.perf_counter()))
            wall = time.perf_counter() - t0
            covid_rows = sum(r["prediction"] == "COVID" for r in results)
            per_batch = 2 if covid_rows else 1
            read_counts(f"batch_predict ({verdict}-forced)",
                        {"fused_photometric": per_batch * n_batches})
            with open(out / "predictions.csv", newline="") as f:
                rows = list(csv.DictReader(f))
            overlays = sorted(out.glob("*_overlay.png"))
            want_covid = PREDICT_IMAGES if verdict == "COVID" else 0
            if (len(rows) != PREDICT_IMAGES or covid_rows != want_covid
                    or len(overlays) != covid_rows
                    or sum(r["prediction"] == "COVID" for r in rows) != covid_rows):
                fail(f"serve path gate 5 ({verdict}): {len(rows)} CSV rows, {covid_rows} "
                     f"COVID, {len(overlays)} overlay files")
            # the last batch alone, between its log line and the one before
            steady = PREDICT_BATCH / (stamps[n_batches - 1] - stamps[n_batches - 2])
            print(f"[{card}] batch_predict ({verdict}-forced), {PREDICT_IMAGES} PNGs of "
                  f"299x299 in {n_batches} batches of {PREDICT_BATCH}, {flag_text}: "
                  f"{len(rows)} CSV rows, {len(overlays)} overlay files, "
                  f"{per_batch * n_batches} photometric launches ({per_batch} a batch); "
                  f"{PREDICT_IMAGES / wall:.1f} img/s over the whole call ({wall:.3f} s, "
                  f"loading both .pt included), {steady:.1f} img/s in its last batch "
                  f"(decode, resize, forwards, overlays and PNG writes; host clock)")


ZOO_CLS = ("VGG16", "VGG19")
ZOO_SEG = ("AttentionUNet", "R2Unet", "R2AttUnet")


def _zoo_batch(name: str) -> int:
    """The recipe's batch: TrainConfig.cls_batch_size or seg_batch_size."""
    from medseg_tpu_torch.core.config import TrainConfig

    cfg = TrainConfig()
    return cfg.cls_batch_size if name in ZOO_CLS else cfg.seg_batch_size


def _zoo_data(name: str, size: int = SIZE, steps: int = ZOO_STEPS, val: int = ZOO_VAL,
              batch: int = 0):
    """(train loader, validation loader) on the card's device cache: `steps`
    shuffled batches of the recipe's size and `val` validation batches of
    synthetic_cls or synthetic_seg at `size`."""
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg

    b = batch or _zoo_batch(name)
    make = synthetic_cls if name in ZOO_CLS else synthetic_seg
    ds = make(n=(steps + val) * b, img_size=size, seed=SEED)
    n = steps * b
    return (BatchLoader(ds, b, shuffle=True, seed=SEED, indices=np.arange(n),
                        device_cache=True),
            BatchLoader(ds, b, shuffle=False, indices=np.arange(n, n + val * b),
                        device_cache=True))


@_on_host_clock
def _zoo_train(card: str, name: str, root: str):
    """train_model(name) bf16 at 256px over ZOO_EPOCHS epochs (VGG: the stage
    switch after epoch 1), then a resume to one more; gates 1-3: the logs,
    exactly one B1 launch a step and one B2 launch a validation batch in
    each run, the best .pt loading strictly into a fresh model.  Returns
    the trained model and its train loader."""
    from medseg_tpu_torch.core.config import AugmentConfig, TrainConfig
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.eval.harness import load_model_bundle
    from medseg_tpu_torch.train import train_model

    seg = name in ZOO_SEG
    train_loader, val_loader = _zoo_data(name)
    n_steps, n_val = len(train_loader), len(val_loader)
    pattern = re.compile(rf"\[{name}\] Ep(?P<ep>\d+): TrainLoss (?P<train>\S+) "
                         rf"(\(Acc \S+%\) )?\| ValLoss (?P<val>\S+) \| (ValAcc|IoU) \S+")
    # seg at lr 1e-4, as the seg path (the recipe's 1e-6 moves a random init
    # little in a few steps); VGG's stage 1 at 1e-5 and stage 2 at the
    # recipe's 1e-6: at the recipe's stage-1 1e-4, AdamW moves the 25088
    # inputs of classifier.0 together and the training loss grows
    cfg = dict(compute_dtype="bfloat16", save_root=root, stage1_epochs=1,
               stage1_lr=1e-5, lr=1e-4 if seg else 1e-6)
    runs = []
    for epochs, resume in ((ZOO_EPOCHS, False), (ZOO_EPOCHS + 1, True)):
        logs = []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = train_model(name, train_loader, val_loader, TrainConfig(epochs=epochs, **cfg),
                          AugmentConfig(), seed=SEED, save=True, resume=resume,
                          log=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = ZOO_EPOCHS if not resume else 1
        read_counts(f"zoo path, {name} ({'resume' if resume else 'train'})",
                    {"warp_affine": ran * n_steps, "fused_photometric": ran * n_val})
        eps = [r[0] for r in _epoch_lines(logs, f"zoo path, {name}", pattern)]
        want = [ZOO_EPOCHS + 1] if resume else list(range(1, ZOO_EPOCHS + 1))
        text = "\n".join(logs)
        if eps != want or (resume and f"Resumed {name} from epoch {ZOO_EPOCHS}" not in text) \
                or (not seg and not resume and "STAGE 2" not in text):
            fail(f"zoo path, {name}: expected epochs {want}"
                 f"{'' if seg or resume else ' and the stage switch'}: {logs}")
        runs.append((wall, [line.strip() for line in logs if line.strip()]))
    sub = "segmentation_models" if seg else "classification_models"
    (Path(root) / sub / f"{name}_resume.pt").unlink()  # VGG's: 1.6 GB
    bundle = load_model_bundle(name, root, seg=seg)
    if bundle is None:
        fail(f"zoo path, {name}: no best checkpoint was written: {runs[0][1]}")
    get_model(name)["factory"]().load_state_dict(bundle[0], strict=True)
    print(f"[{card}] zoo path, train_model({name!r}) bf16 B={train_loader.batch_size} at "
          f"{SIZE}px, {ZOO_EPOCHS} epochs of {n_steps} steps + {n_val} validation "
          f"batches (seed {SEED}) in {runs[0][0]:.3f} s, a resume to epoch "
          f"{ZOO_EPOCHS + 1} in {runs[1][0]:.3f} s (host clock, checkpoints and cuDNN "
          f"plans included); {n_steps} B1 + {n_val} B2 launches an epoch; the best "
          f".pt loads strictly: " + " / ".join(runs[0][1] + runs[1][1][-2:]))
    return res.model, train_loader


def _zoo_step(name: str, model, opt, gen):
    """(the model's train step, its augmentation: one B1 launch)."""
    from medseg_tpu_torch.ops.augment import augment_batch
    from medseg_tpu_torch.train import steps as S

    if name in ZOO_CLS:
        def prep(g, imgs, targets):
            return augment_batch(g, imgs, out_dtype=torch.bfloat16)[0], targets
        return (lambda imgs, t: S.cls_train_step(model, opt, imgs, t, gen, 0.1, prep)[0],
                prep)

    def prep(g, imgs, targets):
        return augment_batch(g, imgs, targets, out_dtype=torch.bfloat16)
    return lambda imgs, t: S.seg_train_step(model, opt, imgs, t, gen, prep), prep


def _zoo_readings(card: str, name: str, model, loader, sync_gate: bool):
    """The model's steady bf16 step from its trained weights (every
    parameter trainable; VGG's dropouts on) through _steady_steps without
    the split: ZOO_RATE_STEPS steps by host clock, gate 6 over
    ZOO_SYNC_STEPS steps when sync_gate, the whole step's device time over
    sessions of 2 steps and its device operations; and readings of the
    convs' TFLOP/s (their forward from its shapes, the backward twice
    that) and the peak memory.  Returns gate 6's fault or None."""
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train.freeze import all_trainable, set_trainable

    model.train()
    opt = S.build_optimizer(1e-6, 5e-4, 1.0, set_trainable(model, all_trainable))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step, prep = _zoo_step(name, model, opt, gen)
    b = loader.batch_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # sessions of R2 steps (~3800 device operations each) counted up to 11
    # records apart: 11410, 11410, 11418 and 11408, 11418, 11407 for 3 steps
    sync_fault, xb, dev_ms, step_s = _steady_steps(
        card, "zoo path", f"{name} bf16 step B={b} at {SIZE}px", b, loader, step, prep,
        None, opt, gen, lost=lambda reps: 10 * reps, rate_steps=ZOO_RATE_STEPS,
        sync_steps=ZOO_SYNC_STEPS if sync_gate else 0, whole_reps=2, split=False)
    peak = torch.cuda.max_memory_allocated()
    kw = {"generator": gen} if name in ZOO_CLS else {}
    flops = 3 * sum(conv_flops(model, xb, **kw).values())
    rate = flops / dev_ms / 1e9
    print(f"[{card}] zoo path, {name} bf16 step B={b} at {SIZE}px: the convs' "
          f"{flops / 1e12:.3f} TFLOP a step (3x their forward's) at {rate:.1f} TFLOP/s, "
          f"{rate * 1e12 / BF16_FLOPS_PER_S:.1%} of the bf16 peak; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated over the warm-up, "
          f"{ZOO_RATE_STEPS} timed and {ZOO_SYNC_STEPS if sync_gate else 0} checked steps)")
    return sync_fault


def _zoo_recipe(name: str, state: dict):
    """Gate 4's (build, step, loss64) for a zoo model from `state`: VGG's
    dropouts off, every parameter trainable, label-smoothed CE or BCE with
    logits (see _check_card_against_cpu)."""
    import torch.nn.functional as F

    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train.freeze import all_trainable, set_trainable

    seg = name in ZOO_SEG

    def build(device, dtype):
        model = get_model(name)["factory"](dtype=dtype, device=device)
        model.load_state_dict(state, strict=True)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        if dtype == torch.float64:
            model.double()
        return model, S.build_optimizer(PARITY_LR, 5e-4, 1.0,
                                        set_trainable(model.train(), all_trainable))

    def loss64(model, x, y, k=3):
        out = model(x)
        if seg:
            t = y.to(out.dtype)
            return -(t * F.logsigmoid(out) + (1.0 - t) * F.logsigmoid(-out)).mean()
        target = (y[:, None] == torch.arange(k, device=y.device)).to(out.dtype) * 0.9 + 0.1 / k
        return -(target * torch.log_softmax(out, -1)).sum(-1).mean()

    if seg:
        return build, S.seg_train_step, loss64
    return build, (lambda m, o, x, y, g: S.cls_train_step(m, o, x, y, g, 0.1)[0]), loss64


def _zoo_parity(card: str, name: str, state: dict) -> None:
    """Gates 4 and 5 for one zoo model at ZOO_PARITY_SIZE px, B=ZOO_PARITY_BATCH,
    full width (float64 R2 steps at 256px are too slow for the CPU): the
    trained weights, VGG's dropouts off, every parameter trainable.

    Gate 4 runs the steps in float64 on the card too, held to the CPU's
    float64 within 1e-9 (the card's arithmetic is the CPU's: 1e-13 apart
    or closer).  The R2 models' float32 runs may be 7x, not 2x, the CPU
    float32's distance from float64: over 15 readings of the two R2
    models (gradients, parameters, statistics; trained and initial
    weights) the card's distance was 0.09-3.3x the CPU's, float32 noise
    through 108 training BatchNorms a forward whose statistics the card
    sums in float32 and the CPU in float64; 7 is twice the largest ratio
    seen, as 2 is for the ResNets (at most 1.1x seen).  The CPU half runs in
    the CPU worker."""
    from medseg_tpu_torch.ops.augment import augment_batch

    loader, _ = _zoo_data(name, size=ZOO_PARITY_SIZE, steps=1, val=1,
                          batch=ZOO_PARITY_BATCH)
    images, targets = next(iter(loader))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if name in ZOO_SEG:
        x, y = augment_batch(gen, images, targets)
    else:
        x, y = augment_batch(gen, images)[0], targets
    _check_card_against_cpu(
        card, f"zoo path, {name}", f"{name} B={ZOO_PARITY_BATCH} at {ZOO_PARITY_SIZE}px, "
        f"every parameter trainable", *_zoo_recipe(name, state), x.cpu(), y.cpu(),
        factor=7.0 if name.startswith("R2") else 2.0, card64=True,
        recipe=("zoo", name, state))


@_on_host_clock
def _zoo_eval(card: str, root: str) -> None:
    """The five best .pt through test_all_models (one B2 launch a batch of
    EVAL_BATCH; the other models of the zoo have no weights and are
    skipped) -> print_summary -> save_results_to_csv, both CSVs read
    back."""
    from medseg_tpu_torch.core.config import EvalConfig
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.eval.csv_io import save_results_to_csv
    from medseg_tpu_torch.eval.harness import print_summary, test_all_models

    loaders = {}
    for family, name in (("cls", "VGG16"), ("seg", "AttentionUNet")):
        ds = _zoo_data(name)[1].ds
        loaders[family] = BatchLoader(ds, EVAL_BATCH, shuffle=False,
                                      indices=np.arange(ZOO_STEPS * _zoo_batch(name),
                                                        len(ds)))
    logs = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = test_all_models(loaders["cls"], loaders["seg"],
                              EvalConfig(weights_root=root), log=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    read_counts("zoo eval", {"fused_photometric": len(ZOO_CLS) * len(loaders["cls"])
                             + len(ZOO_SEG) * len(loaders["seg"])})
    if sorted(results) != sorted(ZOO_CLS + ZOO_SEG):
        fail(f"zoo eval: results for {list(results)}; log {logs}")
    for name, res in results.items():
        if not all(0.0 <= float(res[k]) <= 100.0 for k in res if k != "confusion_matrix"
                   and not k.endswith("per_class")):
            fail(f"zoo eval, {name}: metrics out of range: {res}")
    print_summary(results)
    csvs = [Path(root) / "results" / f for f in ("cls.csv", "seg.csv")]
    save_results_to_csv(results, *map(str, csvs), log=lambda *_: None)
    for path, names in zip(csvs, (ZOO_CLS, ZOO_SEG)):
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        got = {r.pop("Model"): {k: float(v) for k, v in r.items()} for r in rows}
        if sorted(got) != sorted(names) or any(
                results[n][k] != v for n in got for k, v in got[n].items()):
            fail(f"zoo eval: {path.name} reads back as {rows}")
    print(f"[{card}] zoo eval, the five best .pt through test_all_models ("
          f"{len(loaders['cls'])} classification and {len(loaders['seg'])} segmentation "
          f"batches of {EVAL_BATCH}, one B2 launch each a model): {wall:.3f} s; "
          + "; ".join(f"{n} {results[n]['accuracy']:.2f}%" for n in ZOO_CLS) + "; "
          + "; ".join(f"{n} Dice {results[n]['dice']:.2f}%" for n in ZOO_SEG)
          + "; both CSVs read back to the metrics")


def per_call_ms(fn, reps: int, kname: str, what: str):
    """The median over profiler sessions of the named kernel's device time
    per recorded launch, and each session's: late in a run, sessions of 50
    launches recorded 49 (and one marker of two) three times in a row."""
    times = []
    for events in _sessions(fn, reps):
        n = sum(e.count for e in events if kname in e.key)
        if not reps - 2 <= n <= reps:
            fail(f"{what}: {n} launches of {kname} recorded for {reps} calls")
        times.append(sum(e.device_time_total for e in events if kname in e.key) / n / 1e3)
    return float(np.median(times)), times


def _zoo_kernel_checks(card: str) -> None:
    """The kernel forms the zoo path adds, each against its plain version at
    tolerance 0 and timed by device time beside its byte bound: B1 at C=3
    with bf16 out and the epilogue at VGG's train B=16, B2's eval form f32
    at 224^2 (VGG's serving grid) at B=1 and 8, and B2's eval form bf16 at
    B=16, 256^2 (VGG's validation)."""
    from medseg_tpu_torch.core.config import AugmentConfig, IMAGENET_MEAN, IMAGENET_STD
    from medseg_tpu_torch.ops.augment import _combined_matrices, sample_augment_params
    from medseg_tpu_torch.ops.kernels.warp_kernel import warp_affine_kernel
    from medseg_tpu_torch.ops.warp_fast import warp_affine_fast

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def u8(b, size):
        return torch.randint(0, 256, (b, size, size, 3), generator=gen, device="cuda",
                             dtype=torch.uint8)

    b = _zoo_batch("VGG16")
    imgs = u8(b, SIZE)
    p = sample_augment_params(gen, b, AugmentConfig())
    mats = _combined_matrices(p, SIZE, SIZE)
    kw = dict(out_dtype=torch.bfloat16, alpha=p.alpha, beta=p.beta,
              mean=tuple(m * 255.0 for m in IMAGENET_MEAN),
              std=tuple(s * 255.0 for s in IMAGENET_STD))
    norm = dict(mean=IMAGENET_MEAN, std=IMAGENET_STD)
    # (name, kernel, plain, kernel name, reps, bound, same-traffic conversion)
    cases = [(f"B1 C=3 u8->bf16 with epilogue B={b} {SIZE}^2 (VGG train step)",
              lambda: warp_affine_kernel(imgs, mats, **kw),
              lambda: warp_affine_fast(imgs, mats, **kw), "warp_affine_kernel<", 50,
              warp_bound_ms(b, SIZE, SIZE, 3, 2), None)]
    cases += [b2_eval_form(u8(bb, size), dtype, norm, f"({what})")
              for bb, size, dtype, what in ((1, 224, torch.float32, "VGG serving"),
                                            (8, 224, torch.float32, "VGG serving"),
                                            (b, SIZE, torch.bfloat16, "VGG validation"))]
    check_forms(card, "zoo kernel check", cases)


def b2_eval_form(x: torch.Tensor, dtype, norm: dict, what: str) -> tuple:
    """A check_forms case: B2's eval form of uint8 `x` with `norm`'s mean
    and std, out in `dtype`."""
    from medseg_tpu_torch.ops.kernels.photometric import (fused_photometric,
                                                          fused_photometric_reference)

    b, h, w, c = x.shape
    return (f"B2 eval form u8->{str(dtype)[6:]} B={b} {h}^2 {what}",
            functools.partial(fused_photometric, x, None, None, None, out_dtype=dtype,
                              **norm),
            functools.partial(fused_photometric_reference, x, None, None, None,
                              out_dtype=dtype, **norm), "photometric_kernel<", 100,
            photometric_bound_ms(b, h, w, c, dtype.itemsize, per_sample=False),
            lambda: x.to(dtype))


def check_forms(card: str, label: str, cases) -> None:
    """Each (name, kernel, plain, kernel name, reps, (bound ms, by), convert)
    case against its plain version at tolerance 0, then timed by device
    time per launch beside its bound, its plain version and, where given,
    a conversion that moves the same bytes (`x.to(dtype)`)."""
    for what, kernel, plain, kname, reps, (b_ms, b_by), convert in cases:
        got = kernel()
        torch.cuda.synchronize()
        err = (got.float() - plain().float()).abs().max().item()
        if err != 0.0:
            fail(f"{label}, {what}: max_abs_err {err} against the plain version")
        ms, sessions = per_call_ms(kernel, reps, kname, label)
        plain_ms = float(np.median(session_times(plain, 5, what=f"plain {what}",
                                                 lost=5)[0]))
        same = ""
        if convert is not None:
            conv_ms, _ = per_call_ms(convert, reps, "direct_copy_kernel", label)
            same = f"; same-traffic x.to(dtype) {conv_ms:.4f} ms"
        print(f"[{card}] {label}, {what}: max_abs_err=0.0 tol=0 (same float32 "
              f"operation order, no FMA); kernel {ms:.4f} ms (sessions "
              f"{[round(t, 4) for t in sessions]}), bound {b_ms:.4f} ms "
              f"({b_by}), {b_ms / ms:.0%} of it; plain {plain_ms:.4f} ms{same}")


def _zoo_serve_weights(card: str, base: Path, probe: torch.Tensor) -> Path:
    """VGG16, AttentionUNet and R2AttUnet float32 (init_weights from SEED,
    random BatchNorm statistics) written as the reference's .pt under one
    root, VGG16's head biased to COVID (4x the largest |logit| of `probe`,
    a uint8 224 grid batch, + 10)."""
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.models.resnet import init_weights
    from medseg_tpu_torch.ops.augment import preprocess_eval_batch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for sub in ("classification_models", "segmentation_models"):
        (base / sub).mkdir(parents=True)
    for name in ("VGG16", "AttentionUNet", "R2AttUnet"):
        model = init_weights(get_model(name)["factory"](), gen)
        randomize_bn_stats(model, gen)
        sd = {k: v.cpu() for k, v in model.state_dict().items()}
        if name == "VGG16":
            with torch.inference_mode():
                spread = model.eval()(preprocess_eval_batch(probe)[0]).abs().max().item()
            bias = torch.zeros(3)
            bias[0] = 4.0 * spread + 10.0
            sd["classifier.7.bias"] = bias
            torch.save(sd, base / "classification_models" / "VGG16_best_acc.pt")
        else:
            torch.save(sd, base / "segmentation_models" / f"{name}_best_loss.pt")
    print(f"[{card}] zoo serve weights: VGG16, AttentionUNet and R2AttUnet float32 "
          f"(init_weights, seed {SEED}, random BN statistics); VGG16's head bias "
          f"{4.0 * spread + 10.0:.3f} forces COVID")
    return base


def _zoo_serve(card: str) -> None:
    """`medseg serve` with VGG16 + AttentionUNet float32 .pt, COVID-forced:
    gate 2 (the card's Pipeline against the CPU's on 8 images), then each
    request alone and a burst of 8 over loopback: 2 B2 launches a group,
    each forward on its grid (224 for VGG16, 256 for AttentionUNet), every
    overlay at its request's size; the same burst with R2AttUnet as the
    segmenter; a reading: one B=8 group's device time beside its host
    clock."""
    from medseg_tpu_torch.core.config import EvalConfig
    from medseg_tpu_torch.infer.pipeline import Pipeline
    from medseg_tpu_torch.infer.server import InferenceServer, _decode_image, _encode_png

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 8)
    requests = [_xray_like(rng, h, w) for h, w in SERVE_SHAPES for _ in range(2)]
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        root = _zoo_serve_weights(card, Path(tmp), Pipeline._grid_batch(requests, 224, dev))
        server = InferenceServer(EvalConfig(weights_root=str(root)))
        server.warmup("VGG16", "AttentionUNet", log=lambda *_: None)
        httpd, port = server.start_background()
        try:
            pipe = server.pipeline
            cpu_pipe = Pipeline(EvalConfig(weights_root=str(root)), device="cpu")
            cpu_pipe._load_models("VGG16", "AttentionUNet")
            with server.lock:
                _card_against_cpu(card, pipe, cpu_pipe, requests, "AttentionUNet",
                                  "zoo serve")
            del cpu_pipe
            for seg_name in ("AttentionUNet", "R2AttUnet"):
                bodies = [json.dumps({"image": _encode_png(a), "classification_model":
                                      "VGG16", "segmentation_model": seg_name}).encode()
                          for a in requests]
                batches0 = server.stats["batches"]
                torch.cuda.synchronize()
                reset_counts()
                outs = (([_post(port, b) for b in bodies] if seg_name == "AttentionUNet"
                         else []) + _burst(port, bodies))
                groups = server.stats["batches"] - batches0
                got = read_counts(f"zoo serve ({seg_name})",
                                  {"fused_photometric": 2 * groups})
                grids = ({s[1:3] for s in pipe._cls[1].seen_batches},
                         {s[1:3] for s in pipe._seg[1].seen_batches})
                if grids != ({(224, 224)}, {(SIZE, SIZE)}) or pipe._seg[0] != seg_name:
                    fail(f"zoo serve: grids {grids} for VGG16 + {pipe._seg[0]}")
                for out, img in zip(outs, requests + requests):
                    shape = _decode_image(out["overlay"]).shape if out["overlay"] else None
                    if out["prediction"] != "COVID" or shape != img.shape:
                        fail(f"zoo serve ({seg_name}): {out['prediction']}, overlay "
                             f"{shape} for a {img.shape} request")
                print(f"[{card}] zoo serve, VGG16 + {seg_name}: {len(outs)} requests in "
                      f"{groups} groups, {got['fused_photometric']} B2 launches (2 a "
                      f"group); grids {sorted(grids[0])} and {sorted(grids[1])}; every "
                      f"overlay decodes to its request's shape")

            # the reading under PyTorch's default flags, as the serve path's
            torch.backends.cudnn.allow_tf32 = True
            group = [requests[0]] * Pipeline.MAX_BATCH
            with server.lock:
                pipe._load_models("VGG16", "AttentionUNet")
                pipe.process_batch(group, "AttentionUNet")
                host = []
                with host_clock():
                    for _ in range(5):
                        t0 = time.perf_counter()
                        pipe.process_batch(group, "AttentionUNet")
                        host.append((time.perf_counter() - t0) * 1e3)
                times, top = session_times(lambda: pipe.process_batch(group, "AttentionUNet"),
                                           3, what="a zoo group", lost=3)
            dev_ms, host_ms = float(np.median(times)), float(np.median(host))
            print(f"[{card}] zoo serve, one B={len(group)} COVID group of 299x299 images "
                  f"through VGG16 (224) + AttentionUNet (256) float32, PyTorch's default "
                  f"flags (cudnn.allow_tf32=True): device "
                  f"{dev_ms:.4f} ms against {host_ms:.3f} ms of host clock (median of 5), "
                  f"so the card idles {1.0 - dev_ms / host_ms:.1%}; costliest operations "
                  f"(ms per group): {[(round(t, 4), n) for t, n in top[:3]]}")
        finally:
            torch.backends.cudnn.allow_tf32 = False
            httpd.shutdown()
            httpd.server_close()


def run_zoo_path(card: str) -> None:
    """The rest of the CNN zoo at full width: for each of VGG16, VGG19,
    AttentionUNet, R2Unet and R2AttUnet, train_model bf16 at 256px with a
    resume and its best .pt (gates 1-3), the steady step's readings with
    gate 6 (AttentionUNet's also at B=ZOO_BIG_SEG_BATCH, the JAX bench's
    shape), and gates 4 and 5 at ZOO_PARITY_SIZE px; then the five .pt
    through test_all_models into the CSVs and the VGG16 + AttentionUNet
    server.  The zoo's kernel forms are checked with the other kernel
    checks, before the paths (_zoo_kernel_checks): late in a run the
    profiler once recorded 70 of 100 launches of B2 at B=1."""
    faults = {}
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as root:
        for name in ZOO_CLS + ZOO_SEG:
            t0 = time.perf_counter()
            model, train_loader = _zoo_train(card, name, root)
            state = {k: v.cpu() for k, v in model.state_dict().items()}
            t1 = time.perf_counter()
            _zoo_parity(card, name, state)  # the CPU half runs in the worker
            t2 = time.perf_counter()
            fault = _zoo_readings(card, name, model, train_loader, sync_gate=True)
            if fault is not None:
                faults[name] = fault
            if name == "AttentionUNet":
                big, _ = _zoo_data(name, steps=2, val=1, batch=ZOO_BIG_SEG_BATCH)
                _zoo_readings(card, name, model, big, sync_gate=False)
            del model, train_loader, state
            torch.cuda.empty_cache()
            print(f"[{card}] zoo path, {name}: {time.perf_counter() - t0:.1f} s in all, "
                  f"gates 4 and 5 {t2 - t1:.1f} s of it (the card's half; the CPU's in "
                  f"the worker)")
        t0 = time.perf_counter()
        _zoo_eval(card, root)
    t1 = time.perf_counter()
    _zoo_serve(card)
    print(f"[{card}] zoo path: eval {t1 - t0:.1f} s, serve {time.perf_counter() - t1:.1f} s")
    if _WORKER is not None:
        _WORKER.drain(card)
    if faults:
        fail("zoo path: a train step synchronized with the host:\n"
             + "\n".join(f"{n}: {f}" for n, f in faults.items()))


CLIP_EVAL_SAMPLES = 64  # clip path: a synthetic 256px split, 4 batches of 16
CLIP_SHAPES = ((299, 299),) * 3 + ((384, 512),) * 3 + ((1024, 1024),) * 2  # (H, W)
CLIP_PAIRS = (("CLIP", "CLIPSeg"), ("ResNet18", "CLIPSeg"), ("CLIP", "ResNetUnet"))
CLIP_REQUESTS = 40  # sequential 299x299 requests timed through CLIP + CLIPSeg
CLIP_EOS = 49407  # eos_token_id of CLIP's vocabulary; 49406 starts a prompt


def _clip_kernel_checks(card: str) -> None:
    """B2's forms on the clip path, through check_forms: the eval form f32
    with CLIP's mean and std at CLIP's 224^2 (672-byte rows) and CLIPSeg's
    352^2 (1056-byte rows), B=1 and 8."""
    from medseg_tpu_torch.core.config import (CLIP_IMG_SIZE, CLIP_MEAN, CLIP_STD,
                                              CLIPSEG_IMG_SIZE)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    norm = dict(mean=CLIP_MEAN, std=CLIP_STD)
    check_forms(card, "clip kernel check", [
        b2_eval_form(torch.randint(0, 256, (b, size, size, 3), generator=gen,
                                   device="cuda", dtype=torch.uint8), torch.float32, norm,
                     f"with CLIP's mean/std ({what} serving)")
        for size, what in ((CLIP_IMG_SIZE, "CLIP"), (CLIPSEG_IMG_SIZE, "CLIPSeg"))
        for b in (1, 8)])


def _clip_weights(card: str, base: Path, probe: torch.Tensor) -> dict:
    """CLIP (ViT-B/32, the full CLIPModel with its 49408-token text tower)
    and CLIPSeg (rd64-refined, ViT-B/16) float32, init_weights from SEED,
    written as the reference's HF-named .pt under `base/clip`; a prompt-ids
    bundle of arbitrary ids ending in eos; and the serve path's
    COVID-forced ResNet18 + ResNetUnet root (_serve_weights), with both
    CLIP files linked into it.  CLIP is COVID-forced too, as ResNet18 by
    its head bias: post_layernorm's bias 30 on feature 0 and
    visual_projection's column 0 at 10x the unit part of COVID's prompt
    feature orthogonal to the other two prompts' make every image's
    feature score COVID highest, so every group runs the segmenter.
    Returns {"eval": the CLIP-only root, "serve": the four-model root,
    "ids": the bundle}."""
    from medseg_tpu_torch.interop.prompts import ALL_PROMPTS
    from medseg_tpu_torch.interop.text_features import clip_text_features
    from medseg_tpu_torch.models.clip import CLIPModule, init_weights
    from medseg_tpu_torch.models.clipseg import CLIPSegModel

    rng = np.random.default_rng(SEED)
    rows = [[49406] + rng.integers(1, 49406, n).tolist() + [CLIP_EOS] for n in (13, 10, 9)]
    width = max(map(len, rows))
    bundle = {"prompts": list(ALL_PROMPTS),
              "clip": [r + [CLIP_EOS] * (width - len(r)) for r in rows],
              "clipseg": [[49406, int(rng.integers(1, 49406)), CLIP_EOS]]}
    ids = base / "prompt_ids.json"
    ids.write_text(json.dumps(bundle))

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    serve = _serve_weights(card, base / "cnn", probe)["COVID"]
    sizes = []
    for name, module, sub, suffix in (
            ("CLIP", CLIPModule, "classification_models", "best_acc"),
            ("CLIPSeg", CLIPSegModel, "segmentation_models", "best_loss")):
        with torch.device("cuda"):
            model = init_weights(module(), gen)
        sd = {k: v.cpu() for k, v in model.state_dict().items()}
        if name == "CLIP":
            feats = clip_text_features(sd, bundle["clip"])
            others, _ = torch.linalg.qr(feats[1:].T)
            covid = feats[0] - others @ (others.T @ feats[0])
            sd["vision_model.post_layernorm.bias"][0] = 30.0
            sd["visual_projection.weight"][:, 0] = (10.0 * covid / covid.norm()).cpu()
        path = base / "clip" / sub / f"{name}_{suffix}.pt"
        path.parent.mkdir(parents=True)
        torch.save(sd, path)
        os.link(path, serve / sub / path.name)
        sizes.append(path.stat().st_size)
        del model, sd
    print(f"[{card}] clip path weights: CLIP ViT-B/32 and CLIPSeg rd64-refined float32 "
          f"(init_weights, seed {SEED}; CLIP's image side biased to COVID's prompt "
          f"feature), {sum(sizes) / 1e9:.3f} GB of .pt; prompt ids {bundle['clip']} and "
          f"{bundle['clipseg']} (arbitrary, eos {CLIP_EOS})")
    return {"eval": base / "clip", "serve": serve, "ids": ids}


@_on_host_clock
def _clip_eval(card: str, root: Path) -> None:
    """`medseg eval` with CLIP and CLIPSeg: test_all_models over a synthetic
    256px split (the other eight models have no weights), with no B2
    launch (the harness resizes floats to 224 and 352), -> both CSVs, read
    back; the prompt features and CLIPSeg's embedding on the card within
    1e-5 of the CPU's."""
    from medseg_tpu_torch.core.config import EvalConfig
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg
    from medseg_tpu_torch.eval.csv_io import save_results_to_csv
    from medseg_tpu_torch.eval.harness import load_model_bundle, print_summary, test_all_models

    loaders = [BatchLoader(make(n=CLIP_EVAL_SAMPLES, img_size=SIZE, seed=SEED), EVAL_BATCH,
                           shuffle=False) for make in (synthetic_cls, synthetic_seg)]
    logs = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = test_all_models(*loaders, EvalConfig(batch_size=EVAL_BATCH,
                                                   weights_root=str(root)), log=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    read_counts("clip eval (the harness's CLIP branches launch no B2)", {})
    if sorted(results) != ["CLIP", "CLIPSeg"]:
        fail(f"clip eval: results for {list(results)}; log {logs}")
    if results["CLIP"]["confusion_matrix"].sum() != CLIP_EVAL_SAMPLES or not all(
            0.0 <= float(v) <= 100.0 for v in results["CLIPSeg"].values()):
        fail(f"clip eval: {results}")
    print_summary(results)
    csvs = [root / "results" / f for f in ("cls.csv", "seg.csv")]
    save_results_to_csv(results, *map(str, csvs), log=lambda *_: None)
    for path, name in zip(csvs, ("CLIP", "CLIPSeg")):
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        got = {r.pop("Model"): {k: float(v) for k, v in r.items()} for r in rows}
        if list(got) != [name] or any(results[name][k] != v for k, v in got[name].items()):
            fail(f"clip eval: {path.name} reads back as {rows}")
    errs = {}
    for name, seg, key in (("CLIP", False, "text_features"), ("CLIPSeg", True, "cond")):
        on_card = load_model_bundle(name, str(root), seg)[1][key]
        on_cpu = load_model_bundle(name, str(root), seg, device="cpu")[1][key]
        errs[key] = (on_card.cpu() - on_cpu).abs().max().item()
        if not errs[key] <= 1e-5 or on_card.device.type != "cuda":
            fail(f"clip eval: {name}'s {key} on the card are {errs[key]} from the CPU's")
    print(f"[{card}] clip eval, CLIP and CLIPSeg .pt through test_all_models ("
          f"{CLIP_EVAL_SAMPLES} images at {SIZE}px in batches of {EVAL_BATCH}, bicubic "
          f"to 224 and 352 in float32): {wall:.3f} s (host clock, text towers and "
          f"loading included), 0 B2 launches; CLIP accuracy "
          f"{results['CLIP']['accuracy']:.2f}%, CLIPSeg Dice {results['CLIPSeg']['dice']:.2f}%;"
          f" both CSVs read back; card vs CPU: text_features max_abs_err="
          f"{errs['text_features']:.3e}, cond max_abs_err={errs['cond']:.3e} (tol 1e-5)")


def _record_groups(pipe) -> list:
    """Wrap pipe.process_batch to record each group's predictions."""
    groups, process = [], pipe.process_batch

    def recording(images, segmentation_model_name, overlay_opacity=0.5):
        out = process(images, segmentation_model_name, overlay_opacity)
        groups.append([o[0] for o in out])
        return out

    pipe.process_batch = recording
    return groups


def _clip_serve_gates(card: str, server, port: int, pair, requests) -> int:
    """One server's gates: each of the 8 requests alone, then a burst of 8;
    B2 launches exactly 1 a group + 1 for each group with a COVID
    prediction, counted from the groups' predictions (both classifiers are
    COVID-forced, so 2 a group), no new batch shape after warmup, overlays
    at each request's size for COVID and none otherwise, /health names the
    pair.  Returns the B2 launches."""
    from medseg_tpu_torch.infer.server import _decode_image, _encode_png

    pipe = server.pipeline
    groups = _record_groups(pipe)
    seen = (set(pipe._cls[1].seen_batches), set(pipe._seg[1].seen_batches))
    bodies = [json.dumps({"image": _encode_png(a), "classification_model": pair[0],
                          "segmentation_model": pair[1]}).encode() for a in requests]
    batches0 = server.stats["batches"]
    torch.cuda.synchronize()
    reset_counts()
    outs = [_post(port, b) for b in bodies] + _burst(port, bodies)
    torch.cuda.synchronize()
    want = sum(1 + ("COVID" in g) for g in groups)
    read_counts(f"clip serve ({pair[0]} + {pair[1]})", {"fused_photometric": want})
    if len(groups) != server.stats["batches"] - batches0 or want != 2 * len(groups):
        fail(f"clip serve ({pair}): groups {groups}, batches "
             f"{server.stats['batches'] - batches0}")
    after = (pipe._cls[1].seen_batches, pipe._seg[1].seen_batches)
    if after != seen or server.stats["max_batch"] < 2:
        fail(f"clip serve ({pair}): batch shapes {seen} -> {after}, max_batch "
             f"{server.stats['max_batch']}")
    for out, img in zip(outs, requests + requests):
        covid = out["prediction"] == "COVID"
        shape = _decode_image(out["overlay"]).shape if out["overlay"] else None
        if shape != (img.shape if covid else None):
            fail(f"clip serve ({pair}): {out['prediction']} with overlay {shape} for a "
                 f"{img.shape} request")
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as resp:
        health = json.loads(resp.read())["models"]
    if health != {"classification": pair[0], "segmentation": pair[1]}:
        fail(f"clip serve: /health says {health}")
    covid = sum(o["prediction"] == "COVID" for o in outs)
    print(f"[{card}] clip serve, {pair[0]} + {pair[1]}: {len(outs)} requests ({len(bodies)} "
          f"one at a time, then a burst) in {len(groups)} groups, largest "
          f"{server.stats['max_batch']}, {covid} COVID; B2 launches {want} = 1 a group + 1 "
          f"for each of the {want - len(groups)} groups with COVID; grids "
          f"{sorted({s[1] for s in after[0]})} and {sorted({s[1] for s in after[1]})}; the "
          f"burst met no new batch shape; overlays at each request's size")
    return want


def _clip_card_against_cpu(card: str, pipe, root: Path, arrays) -> None:
    """The card's CLIP + CLIPSeg Pipeline (TF32 off) against the CPU's on the
    8 images: the bicubic uint8 grids equal except off by 1 at rounding
    ties (the CPU's float value within 1e-3 of a .5), CLIP's logits within
    1e-3*max(1, |logit|max) and CLIPSeg's probabilities within 1e-3 on the
    same grid, and the same classes wherever the CPU's top two logits are
    further apart than twice that."""
    from medseg_tpu_torch.core.config import EvalConfig
    from medseg_tpu_torch.infer.pipeline import Pipeline
    from medseg_tpu_torch.ops.image import resize_jax

    cpu = torch.device("cpu")
    cpu_pipe = Pipeline(EvalConfig(weights_root=str(root)), device="cpu")
    cpu_pipe._load_models("CLIP", "CLIPSeg")
    report, outs = [], {}
    for key in ("_cls", "_seg"):
        entry, cpu_entry = getattr(pipe, key), getattr(cpu_pipe, key)
        size, method = Pipeline.input_grid(entry[0])
        grid = Pipeline._grid_batch(arrays, size, pipe.device, method).cpu()
        cpu_grid = Pipeline._grid_batch(arrays, size, cpu, method)
        diff = (grid.int() - cpu_grid.int()).abs()
        raw = torch.cat([resize_jax(torch.from_numpy(a[None]), size, size, method)
                         for a in arrays])
        tie = (raw - raw.floor() - 0.5).abs() < 1e-3
        if diff.max() > 1 or not tie[diff > 0].all():
            fail(f"clip card vs CPU: the {size} grids differ by up to {diff.max()} off ties")
        out = pipe._forward(entry[1], cpu_grid.to(pipe.device))
        out_cpu = cpu_pipe._forward(cpu_entry[1], cpu_grid)
        err = float(np.abs(out - out_cpu).max())
        tol = 1e-3 * max(1.0, float(np.abs(out_cpu).max())) if key == "_cls" else 1e-3
        outs[key] = (out, out_cpu, tol)
        report.append(f"{entry[0]} grid {size}: {int((diff > 0).sum())} of {diff.numel()} "
                      f"uint8 values differ (by 1, at ties); max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            fail(f"clip card vs CPU, {entry[0]}: max_abs_err {err} > {tol}")
    logits, logits_cpu, tol = outs["_cls"]
    top2 = np.sort(logits_cpu, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    same = logits.argmax(-1) == logits_cpu.argmax(-1)
    if not same[clear].all():
        fail(f"clip card vs CPU: classes {logits.argmax(-1)} vs {logits_cpu.argmax(-1)}")
    print(f"[{card}] clip card vs CPU Pipeline (TF32 off), {len(arrays)} images "
          f"{sorted({a.shape[:2] for a in arrays})}: " + "; ".join(report)
          + f"; classes equal on the {int(clear.sum())} images whose top two CPU logits "
          f"are more than 2*tol apart")


def _vit_flops(batch: int, tokens: int, layers: int, hidden: int = 768,
               mlp: int = 3072) -> tuple:
    """(GEMM, SDPA) flops of `layers` ViT encoder layers: q, k, v, out and the
    two MLP projections; QK^T and PV."""
    gemm = 2 * batch * tokens * layers * (4 * hidden * hidden + 2 * hidden * mlp)
    return gemm, 4 * batch * tokens * tokens * hidden * layers


def _event_ms(fn, reps: int = 20) -> float:
    """Milliseconds a call of fn() by CUDA events around `reps` calls after
    three warm-up calls: for operations of 0.05 ms and more, whose launches
    take less host time than the card takes to run them; it needs no
    profiler session, which late in a run may record nothing."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _clip_device_split(card: str, pipe, requests) -> None:
    """Readings: the device time of one B=8 CLIP and CLIPSeg forward (the
    Pipeline's, B2 included) split into GEMMs, SDPA, LayerNorm, B2 and the
    rest, the GEMMs' TFLOP/s from the shapes, the patch embedding's GEMM
    beside cuDNN's conv of the same weights, and peak memory."""
    import torch.nn.functional as F

    from medseg_tpu_torch.infer.pipeline import Pipeline
    from medseg_tpu_torch.ops.clip_prep import clip_preprocess

    kinds = (("GEMM", ("gemm",)), ("SDPA", ("attention", "fmha", "flash", "softmax")),
             ("LayerNorm", ("layer_norm",)), ("B2", ("photometric_kernel",)))
    for key in ("_cls", "_seg"):
        name, fn = getattr(pipe, key)
        model = fn.model
        decoder = getattr(model, "decoder", None)
        tower = (model.clip if decoder is not None else model).vision_model
        cfg = tower.cfg
        layers = (max(model.extract_layers) + 1 if decoder is not None else cfg.num_layers)
        size, method = Pipeline.input_grid(name)
        grid = Pipeline._grid_batch(requests, size, pipe.device, method)
        parts = {k: [] for k, _ in kinds}
        parts["rest"], totals, top = [], [], {}
        for events in _sessions(lambda: fn(grid), 5):
            split = dict.fromkeys(parts, 0.0)
            for e in events:
                kind = next((k for k, words in kinds
                             if any(w in e.key.lower() for w in words)), "rest")
                split[kind] += e.device_time_total / 5 / 1e3
                top[e.key[:50]] = e.device_time_total / 5 / 1e3
            for k, v in split.items():
                parts[k].append(v)
            totals.append(sum(split.values()))
        ms = {k: float(np.median(v)) for k, v in parts.items()}
        b, p, hidden = grid.shape[0], cfg.patch_size, cfg.hidden_size
        tokens = (size // p) ** 2 + 1
        gemm, sdpa = _vit_flops(b, tokens, layers, hidden, cfg.intermediate_size)
        patch = 2 * b * (tokens - 1) * hidden * 3 * p * p
        gemm += patch
        if decoder is not None:  # the reduces and the decoder's layers
            width = decoder.film_mul.out_features
            depth = len(decoder.layers)
            gemm += (depth * 2 * b * tokens * hidden * width + _vit_flops(
                b, tokens, depth, width, decoder.layers[0].mlp.fc1.out_features)[0])
        x = clip_preprocess(grid, size)
        emb = tower.embeddings
        weight = emb.patch_embedding.weight
        nchw = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            patch_ms = _event_ms(lambda: emb.patches(x))
            conv_ms = _event_ms(lambda: F.conv2d(nchw, weight, stride=p))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(grid)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        total = float(np.median(totals))
        costly = sorted(top.items(), key=lambda kv: -kv[1])[:4]
        print(f"[{card}] clip reading, one B={b} {name} forward ({size}^2, {layers} vision "
              f"layers, B2 + model{' + sigmoid' if key == '_seg' else ''}, float32, TF32 "
              f"off) by device time: {total:.4f} ms (sessions "
              f"{[round(t, 4) for t in totals]}); "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f" ms; GEMMs {gemm / 1e9:.1f} GFLOP from the shapes, "
              f"{gemm / ms['GEMM'] / 1e9:.1f} TFLOP/s ({gemm / ms['GEMM'] / 1e9 / 67:.0%} of "
              f"the 67 TFLOP/s float32 rate outside the tensor cores); SDPA "
              f"{sdpa / 1e9:.1f} GFLOP; the patch embedding as a GEMM {patch_ms:.4f} ms "
              f"against cuDNN's conv of the same weights {conv_ms:.4f} ms (CUDA events, "
              f"20 calls); peak memory "
              f"{peak / 2**20:.1f} MiB above the {base / 2**30:.2f} GiB held; costliest "
              f"operations (ms): {[(k, round(v, 4)) for k, v in costly]}")


@_on_host_clock
def _clip_latency(card: str, server, port: int, requests) -> None:
    """Readings: p50/p99 of CLIP_REQUESTS sequential 299x299 requests
    through CLIP + CLIPSeg over loopback, and one request's stages by host
    clock (medians of 10)."""
    from medseg_tpu_torch.infer.overlay import red_overlay
    from medseg_tpu_torch.infer.pipeline import Pipeline
    from medseg_tpu_torch.infer.server import _decode_image, _encode_png

    img = requests[0]
    body = json.dumps({"image": _encode_png(img), "classification_model": "CLIP",
                       "segmentation_model": "CLIPSeg"}).encode()
    lat = []
    for _ in range(CLIP_REQUESTS):
        t0 = time.perf_counter()
        _post(port, body)
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p99 = np.percentile(lat, [50, 99])
    pipe, dev = server.pipeline, server.pipeline.device
    payload = json.loads(body)["image"]
    stages = {}

    def stage(name, fn):
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        stages[name] = float(np.median(times))
        return out

    cls_size, seg_size = (Pipeline.input_grid(n)[0] for n in ("CLIP", "CLIPSeg"))
    with server.lock:
        stage("decode", lambda: _decode_image(payload))
        g_cls = stage(f"_to_grid {cls_size} bicubic",
                      lambda: Pipeline._to_grid(img[None], cls_size, dev, "bicubic"))
        stage("classify (B2 + CLIP + read)", lambda: pipe._forward(pipe._cls[1], g_cls))
        g_seg = stage(f"_to_grid {seg_size} bicubic",
                      lambda: Pipeline._to_grid(img[None], seg_size, dev, "bicubic"))
        probs = stage("segment (B2 + CLIPSeg + sigmoid + read)",
                      lambda: pipe._forward(pipe._seg[1], g_seg)[0, :, :, 0])
        mask = (probs > 0.5).astype(np.uint8) * 255
        stage("overlay + PNG encode", lambda: _encode_png(red_overlay(img, mask)))
    print(f"[{card}] clip reading, {CLIP_REQUESTS} sequential 299x299 requests through "
          f"CLIP + CLIPSeg over loopback (host clock, TF32 off): p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms, max {max(lat):.3f} ms; one request's stages (median of 10): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.3f} ms")


def run_clip_path(card: str) -> int:
    """CLIP and CLIPSeg at full width, float32: the eval gate (_clip_eval),
    then an InferenceServer over loopback for each of CLIP_PAIRS, warmed up
    (_clip_serve_gates), the card's CLIP + CLIPSeg Pipeline against the
    CPU's (_clip_card_against_cpu), and the readings.  Returns the B2
    launches of its servers."""
    from medseg_tpu_torch.core.config import EvalConfig
    from medseg_tpu_torch.infer.pipeline import Pipeline
    from medseg_tpu_torch.infer.server import InferenceServer

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 10)
    requests = [_xray_like(rng, h, w) for h, w in CLIP_SHAPES]
    launches = 0
    env = os.environ.get("MEDSEG_PROMPT_IDS")
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        t0 = time.perf_counter()
        roots = _clip_weights(card, Path(tmp), Pipeline._grid_batch(requests, SIZE, dev))
        os.environ["MEDSEG_PROMPT_IDS"] = str(roots["ids"])
        httpds = []
        try:
            t1 = time.perf_counter()
            _clip_eval(card, roots["eval"])
            t2 = time.perf_counter()
            servers = {}
            for pair in CLIP_PAIRS:
                server = InferenceServer(EvalConfig(weights_root=str(roots["serve"])))
                server.warmup(*pair, log=lambda *_: None)
                httpd, port = server.start_background()
                httpds.append(httpd)
                servers[pair] = (server, port)
            t3 = time.perf_counter()
            for pair, (server, port) in servers.items():
                launches += _clip_serve_gates(card, server, port, pair, requests)
            server, port = servers[CLIP_PAIRS[0]]
            with server.lock:
                _clip_card_against_cpu(card, server.pipeline, roots["serve"], requests)
                _clip_device_split(card, server.pipeline, requests)
            _clip_latency(card, server, port, requests)
            print(f"[{card}] clip path: weights {t1 - t0:.1f} s, eval {t2 - t1:.1f} s, three "
                  f"servers loaded and warmed {t3 - t2:.1f} s, gates and readings "
                  f"{time.perf_counter() - t3:.1f} s")
        finally:
            for httpd in httpds:
                httpd.shutdown()
                httpd.server_close()
            if env is None:
                os.environ.pop("MEDSEG_PROMPT_IDS", None)
            else:
                os.environ["MEDSEG_PROMPT_IDS"] = env
    return launches


FT_TRAIN_CLS = 160  # finetune path: train_cls at 256px; `train` 128/32 (0.2), CLIP 142/18
FT_TRAIN_SEG = 60   # train_seg: ResNetUnet 48/12; CLIPSeg 53/7 = 6 steps of 8 + a ragged 5
FT_TEST = 16        # test_cls and test_seg
FT_TRAIN_EPOCHS = 6  # `train`: crosses the stage-1 -> 2 switch after epoch 5
FT_EPOCHS = 2        # finetune-clip, finetune-clipseg
FT_PREDICT = 8       # `predict`: 299x299 PNGs, one batch
FT_RATE_STEPS = 10   # steady finetune steps timed by host clock
FT_SYNC_STEPS = 5    # ... and under set_sync_debug_mode("error")
FT_SESSION_STEPS = 2  # ... and a profiler session (on an H100, sessions of
#                       5-10 steps of ~900 operations took 34-50 s to read)
FT_PARITY = {"CLIP": 4, "CLIPSeg": 2}  # card against CPU, float32 at full width
# ... within twice the CPU float32's distance from float64, beside the same
# steps in float64 on the card within 1e-9 of the CPU's (2.8e-17 seen).
# The step-1 gradients also pass within FT_GRAD_FLOOR of float64's own
# magnitude: on an H100, CLIPSeg's on the card were 0.6-1.2e-5 of it in L2
# from run to run on the same weights while the CPU float32's distance,
# the yardstick, swung from 2.3e-7 to 6.7e-7 (card/CPU 0.89-4.5x).  The
# parameters after step 3 also pass within FT_UPDATE_FLOOR of float64's
# own update in L2: CLIPSeg's card/CPU ratio there read 0.23-2.7x
FT_GRAD_FLOOR = 1e-4
FT_UPDATE_FLOOR = 1e-2
FT_EPOCH_LINES = {
    "ResNet18": EPOCH_LINE, "ResNetUnet": SEG_EPOCH_LINE,
    "CLIP": re.compile(r"\[CLIP\] Ep(?P<ep>\d+): TrainLoss (?P<train>\S+) \(Acc \S+%\) "
                       r"\| ValLoss (?P<val>\S+) \| ValAcc \S+%"),
    "CLIPSeg": re.compile(r"\[CLIPSeg\] Ep(?P<ep>\d+): TrainLoss (?P<train>\S+) "
                          r"\| ValLoss (?P<val>\S+) \| ValDice \S+")}


@_on_host_clock
def _cli(card: str, argv: list, expected: dict, path: str = "finetune path",
         code: int = 0) -> str:
    """cli.main(argv) in this process, its standard output captured and its
    epoch, summary and report lines printed; the launch counts set to 0
    before and read after (read_counts); fails unless it exits with `code`
    (0: it returns).  Returns the output."""
    import contextlib
    import io

    from medseg_tpu_torch.apps import cli

    out = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = 0
    with contextlib.redirect_stdout(out):
        try:
            cli.main(argv)
        except SystemExit as e:
            got = e.code
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = out.getvalue()
    if got != code:
        fail(f"{path}: cli {' '.join(argv)} exited {got}, not {code}:\n{text[-3000:]}")
    read_counts(f"{path}, cli {argv[0]}", expected)
    keep = [line for line in text.splitlines()
            if re.match(r"\[\w+\] Ep\d|Saved best|--- |[A-Za-z0-9]+ +: |packed |"
                        r"\[WARNING\](?! Weights not found)|Total images|=== Parity|"
                        r"max \|delta\||PARITY|MISSING", line)]
    print(f"[{card}] {path}, cli {' '.join(argv[:3])} ...: {wall:.3f} s (host "
          f"clock); launches {expected}\n" + "\n".join(f"  {line}" for line in keep))
    return text


def _ft_epochs(text: str, name: str, epochs: int) -> list:
    rows = _epoch_lines(text.splitlines(), f"finetune path, {name}", FT_EPOCH_LINES[name])
    if [r[0] for r in rows] != list(range(1, epochs + 1)):
        fail(f"finetune path: {name} logged epochs {[r[0] for r in rows]}, not 1-{epochs}")
    return rows


def _ft_checkpoints(card: str, weights: Path, inits: dict) -> None:
    """The four best checkpoints load strictly into fresh models; CLIP's and
    CLIPSeg's carry the aux tensors they were trained with, and against the
    seeded init (inits: name -> (state, aux, trained prefix)) only the
    trained prefix moved, every tensor of it, bit for bit elsewhere."""
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.eval.harness import load_model_bundle

    for name in ("ResNet18", "ResNetUnet", "CLIP", "CLIPSeg"):
        seg = get_model(name)["task"] == "segmentation"
        bundle = load_model_bundle(name, str(weights), seg)
        if bundle is None:
            fail(f"finetune path: no best checkpoint for {name}")
        sd, extra = bundle
        get_model(name)["factory"](device="cuda").load_state_dict(sd, strict=True)
        if name not in inits:
            continue
        init, aux, prefix = inits[name]
        key, want = aux
        if not torch.equal(extra[key].cpu(), torch.from_numpy(want)):
            fail(f"finetune path: {name}'s aux {key} is not the one it was trained with")
        moved = [k for k, v in init.items() if not torch.equal(sd[k].cpu(), v)]
        trained = [k for k in init if k.startswith(prefix)]
        if moved != trained:
            fail(f"finetune path: {name}: moved {sorted(set(moved) - set(trained))[:5]} "
                 f"outside {prefix}*, or kept {sorted(set(trained) - set(moved))[:5]}")
        print(f"[{card}] finetune path, {name}: the best .pt loads strictly, its aux "
              f"{key} {tuple(want.shape)} equals the one trained with, all {len(trained)} "
              f"{prefix}* tensors moved and the other {len(init) - len(trained)} are bit "
              f"for bit the seeded init")


def _ft_predict(card: str, root: Path, weights: Path, common: list) -> int:
    """`predict --cls-model CLIP --seg-model CLIPSeg` over FT_PREDICT 299x299
    PNGs in one batch, from a copy of the finetuned checkpoints whose CLIP
    aux is COVID-forced (COVID's prompt feature the images' mean feature,
    the others its opposite), so that CLIPSeg serves too: B2 launches
    exactly 1 for CLIP + 1 for CLIPSeg when a row is COVID, an overlay per
    COVID row.  Returns its B2 launches."""
    from PIL import Image

    from medseg_tpu_torch.apps import cli
    from medseg_tpu_torch.core.config import CLIP_IMG_SIZE
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.infer.pipeline import Pipeline
    from medseg_tpu_torch.ops.clip_prep import clip_preprocess
    from medseg_tpu_torch.train.checkpoint import AUX_PREFIX, split_aux

    src = root / "predict_in"
    src.mkdir()
    rng = np.random.default_rng(SEED + 11)
    arrays = [_xray_like(rng, 299, 299) for _ in range(FT_PREDICT)]
    for i, a in enumerate(arrays):
        Image.fromarray(a).save(src / f"xray{i}.png")
    forced = root / "weights_covid"
    for sub in ("classification_models", "segmentation_models"):
        (forced / sub).mkdir(parents=True)
    os.link(weights / "segmentation_models" / "CLIPSeg_best_loss.pt",
            forced / "segmentation_models" / "CLIPSeg_best_loss.pt")
    pt = weights / "classification_models" / "CLIP_best_acc.pt"
    sd, _ = split_aux(torch.load(pt, map_location="cpu", weights_only=True))
    model = get_model("CLIP")["factory"](device="cuda")
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        x = clip_preprocess(Pipeline._grid_batch(arrays, CLIP_IMG_SIZE,
                                                 torch.device("cuda"), "bicubic"),
                            CLIP_IMG_SIZE)
        feats = model.visual_projection(model.vision_model(x)[0])
    mean = torch.nn.functional.normalize(feats, dim=-1).mean(0)
    mean = (mean / mean.norm()).cpu()
    sd[AUX_PREFIX + "text_features"] = torch.stack([mean, -mean, -mean])
    torch.save(sd, forced / "classification_models" / pt.name)
    del model, sd

    out = root / "predict_out"
    argv = (["predict", "--input", str(src), "--output", str(out), "--cls-model", "CLIP",
             "--seg-model", "CLIPSeg"] + common[:2] + ["--weights-root", str(forced)])
    torch.cuda.synchronize()
    reset_counts()
    cli.main(argv)
    torch.cuda.synchronize()
    with open(out / "predictions.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    covid = [r for r in rows if r["prediction"] == "COVID"]
    launches = 1 + (1 if covid else 0)
    read_counts("finetune path, cli predict", {"fused_photometric": launches})
    if (len(rows) != FT_PREDICT or not covid
            or any(not Path(r["overlay_path"]).exists() for r in covid)):
        fail(f"finetune path: predict wrote {rows}")
    print(f"[{card}] finetune path, cli predict --cls-model CLIP --seg-model CLIPSeg (CLIP's "
          f"aux COVID-forced): {len(rows)} rows, {len(covid)} COVID with overlays, "
          f"{launches} B2 launches (1 for CLIP + {launches - 1} for CLIPSeg)")
    return launches


def _ft_gemm_reading(card: str, what: str, step, gemm: float, batch: int) -> None:
    """A reading: one step's GEMMs by device time (profiler kernels with
    "gemm" in their name) against the GEMM flops from the shapes, and the
    peak memory of a step above what the model and optimizer hold."""
    totals, gemm_ms = [], []
    reps = FT_SESSION_STEPS
    for events in _sessions(step, reps):
        totals.append(sum(e.device_time_total for e in events) / reps / 1e3)
        gemm_ms.append(sum(e.device_time_total for e in events
                           if "gemm" in e.key.lower()) / reps / 1e3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    g = float(np.median(gemm_ms))
    print(f"[{card}] finetune reading, {what}: GEMMs {g:.4f} of {float(np.median(totals)):.4f}"
          f" ms of device time a step ({[round(t, 4) for t in gemm_ms]}), "
          f"{gemm / 1e9:.1f} GFLOP from the shapes at {gemm / g / 1e9:.1f} TFLOP/s "
          f"({gemm / g / 1e9 / (F32_FLOPS_PER_S / 1e12):.0%} of the float32 rate outside "
          f"the tensor cores), {batch / float(np.median(totals)) * 1e3:.1f} img/s of device "
          f"time; peak memory {peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held")


def _ft_clip_steady(card: str, model, tf: torch.Tensor, ds):
    """CLIP's finetune step at full width (B=32, 224^2, float32) from the
    trained model: rate, sync gate, device split (_steady_steps), GEMMs and
    peak memory.  Returns gate 6's fault or None."""
    from medseg_tpu_torch.core.config import CLIP_IMG_SIZE, CLIPFinetuneConfig
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.ops.clip_prep import clip_preprocess
    from medseg_tpu_torch.train import losses as L
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train.clip_finetune import clip_train_step
    from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable

    cfg = CLIPFinetuneConfig()
    loader = BatchLoader(ds, cfg.batch_size, shuffle=True, seed=SEED, drop_last=True,
                         device_cache=True)
    model.train()
    opt = S.build_optimizer(cfg.lr, cfg.weight_decay, cfg.grad_clip_norm,
                            set_trainable(model, finetune_filter("CLIP")))
    size = CLIP_IMG_SIZE
    what = f"CLIP finetune step ViT-B/32 float32 B={cfg.batch_size} at {size}^2"
    fault, _, _, _ = _steady_steps(
        card, "finetune path", what, cfg.batch_size, loader,
        lambda imgs, y: clip_train_step(model, opt, imgs, y, tf, size)[0],
        lambda g, imgs, y: (clip_preprocess(imgs, size), y),
        lambda x, y: L.cross_entropy(model(x, tf), y), opt, None,
        lost=lambda reps: reps, rate_steps=FT_RATE_STEPS, sync_steps=FT_SYNC_STEPS,
        whole_reps=FT_SESSION_STEPS, prep_name="preprocess", split_reps=FT_SESSION_STEPS)
    vc = model.vision_model.cfg
    tokens = (size // vc.patch_size) ** 2 + 1
    fwd = _vit_flops(cfg.batch_size, tokens, vc.num_layers, vc.hidden_size,
                     vc.intermediate_size)[0]
    patch = 2 * cfg.batch_size * (tokens - 1) * vc.hidden_size * 3 * vc.patch_size ** 2
    # forward, then the gradients of inputs and weights; the patch GEMM's
    # input (the pixels) takes none
    imgs, labels = next(iter(loader))
    _ft_gemm_reading(card, what, lambda: clip_train_step(model, opt, imgs, labels, tf, size),
                     3 * fwd + 2 * patch, cfg.batch_size)
    return fault


def _ft_clipseg_steady(card: str, model, cond: torch.Tensor, ds):
    """CLIPSeg's finetune step at full width (B=8, 352^2, float32), as
    _ft_clip_steady, and a padded-tail step (B=5 of 8) under the sync
    gate.  Returns gate 6's fault or None."""
    from medseg_tpu_torch.core.config import CLIPSEG_IMG_SIZE, CLIPSegFinetuneConfig
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.train import losses as L
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train.clipseg_finetune import (clipseg_prep, clipseg_train_step,
                                                         pad_rows)
    from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable

    cfg = CLIPSegFinetuneConfig()
    b, size = cfg.batch_size, CLIPSEG_IMG_SIZE
    loader = BatchLoader(ds, b, shuffle=True, seed=SEED, drop_last=True, device_cache=True)
    model.train()
    opt = S.build_optimizer(cfg.lr, cfg.weight_decay, 1.0,
                            set_trainable(model, finetune_filter("CLIPSeg")))
    logit = model.logit_size(size)
    what = f"CLIPSeg finetune step rd64-refined float32 B={b} at {size}^2"
    fault, _, _, _ = _steady_steps(
        card, "finetune path", what, b, loader,
        lambda imgs, m: clipseg_train_step(model, opt, imgs, m, cond, logit, size),
        lambda g, imgs, m: clipseg_prep(imgs, m, size, logit),
        lambda x, m: L.combined_loss(model(x, cond=cond.expand(b, -1)), m), opt, None,
        lost=lambda reps: reps, rate_steps=FT_RATE_STEPS, sync_steps=FT_SYNC_STEPS,
        whole_reps=FT_SESSION_STEPS, prep_name="preprocess", split_reps=FT_SESSION_STEPS)
    imgs, masks = next(iter(loader))
    tail = pad_rows(3, imgs[:5], masks[:5])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        clipseg_train_step(model, opt, *tail, cond, logit, size, n_valid=5)
    except RuntimeError:
        fault = fault or traceback.format_exc()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    vc, dec = model.clip.vision_model.cfg, model.decoder
    tokens = (size // vc.patch_size) ** 2 + 1
    layers = max(model.extract_layers) + 1
    backbone = _vit_flops(b, tokens, layers, vc.hidden_size, vc.intermediate_size)[0]
    backbone += 2 * b * (tokens - 1) * vc.hidden_size * 3 * vc.patch_size ** 2
    width, depth = dec.film_mul.out_features, len(dec.layers)
    decoder = (depth * 2 * b * tokens * vc.hidden_size * width
               + _vit_flops(b, tokens, depth, width, dec.layers[0].mlp.fc1.out_features)[0])
    # the backbone forward only (no_grad); the decoder forward and backward
    _ft_gemm_reading(card, what, lambda: clipseg_train_step(model, opt, imgs, masks, cond,
                                                            logit, size),
                     backbone + 3 * decoder, b)
    return fault


def _ft_parity(card: str, name: str, state: dict, aux: np.ndarray, ds,
               logit: int = 0) -> None:
    """Gate 4 for the finetune recipes (_check_card_against_cpu, no bf16
    gate): 3 float32 steps of the port's own step at full width, TF32 off,
    on the card and the CPU from the finetuned weights, against the same 3
    in float64 on the CPU (the preprocessing's float32 output widened),
    within twice the CPU float32's distance (the step-1 gradients also
    within FT_GRAD_FLOOR of float64's magnitude, the parameters within
    FT_UPDATE_FLOOR of float64's update), and the float64 steps on the
    card within 1e-9 of the CPU's.
    CLIP at B=4; CLIPSeg at B=2, its second step the padded tail (row 0
    padded to 2 under the masked loss; in float64 the ragged B=1 loss) on
    its `logit` grid."""
    from medseg_tpu_torch.core.config import CLIP_IMG_SIZE, CLIPSEG_IMG_SIZE
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.ops.clip_prep import clip_preprocess
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train.clip_finetune import clip_train_step
    from medseg_tpu_torch.train.clipseg_finetune import (clipseg_prep, clipseg_train_step,
                                                         pad_rows)
    from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable

    n = FT_PARITY[name]
    images = torch.from_numpy(np.ascontiguousarray(ds.images[:n]))
    targets = torch.from_numpy(np.ascontiguousarray(
        ds.labels[:n] if name == "CLIP" else ds.masks[:n]))
    calls = [0]  # the steps taken by the run being built

    def build(device, dtype):
        model = get_model(name)["factory"](device="meta")  # no random init to overwrite
        model.load_state_dict({k: v.to(device, dtype, copy=True) for k, v in state.items()},
                              strict=True, assign=True)
        model.train()
        calls[0] = 0
        return model, S.build_optimizer(PARITY_LR, 5e-4, 1.0,
                                        set_trainable(model, finetune_filter(name)))

    def aux_on(device, dtype=torch.float32):
        return torch.from_numpy(aux).to(device, dtype)

    if name == "CLIP":
        size = CLIP_IMG_SIZE

        def step(model, opt, x, y, gen):
            return clip_train_step(model, opt, x, y, aux_on(x.device), size)[0]

        def loss64(model, x, y):
            logits = model(clip_preprocess(x, size).double(), aux_on(x.device, x.dtype))
            target = (y[:, None] == torch.arange(3, device=y.device)).double()
            return -(target * torch.log_softmax(logits, -1)).sum(-1).mean()
        what = f"CLIP ViT-B/32 B={n} at {size}^2 from the finetuned weights"
    else:
        size = CLIPSEG_IMG_SIZE

        def step(model, opt, x, y, gen):
            calls[0] += 1
            cond = aux_on(x.device)
            if calls[0] == 2:  # the padded tail: row 0 padded to n
                return clipseg_train_step(model, opt, *pad_rows(n - 1, x[:1], y[:1]), cond,
                                          logit, size, n_valid=1)
            return clipseg_train_step(model, opt, x, y, cond, logit, size)

        def loss64(model, x, y):
            calls[0] += 1
            if calls[0] == 2:  # the ragged batch the padded tail stands for
                x, y = x[:1], y[:1]
            xp, m = clipseg_prep(x, y, size, logit)
            z = model(xp.double(), cond=aux_on(x.device, torch.float64).expand(x.shape[0], -1))
            m = m.double()
            bce = -(m * torch.nn.functional.logsigmoid(z)
                    + (1 - m) * torch.nn.functional.logsigmoid(-z)).mean()
            p = torch.sigmoid(z)
            dice = 1 - (2 * (p * m).sum() + 1) / (p.sum() + m.sum() + 1)
            return 0.5 * bce + 0.5 * dice
        what = (f"CLIPSeg rd64-refined B={n} at {size}^2 from the finetuned weights, "
                f"step 2 the padded tail")
    _check_card_against_cpu(card, "finetune path", what, build, step, loss64, images,
                            targets, card64=True, bf16=False, grad_floor=FT_GRAD_FLOOR,
                            update_floor=FT_UPDATE_FLOOR,
                            zero_grad=lambda n: n.endswith("self_attn.k_proj.bias"))


def run_finetune_path(card: str) -> dict:
    """The CLI's train half at full width, as a user runs it (tools/
    certify_workflow.py's sequence): synthetic packed caches at 256px, then
    through cli.main in this process `train ResNet18 ResNetUnet --epochs 6`,
    `finetune-clip --random-init --epochs 2` (ViT-B/32 at 224, B=32),
    `finetune-clipseg --random-init --epochs 2` (rd64-refined at 352, B=8;
    the train split ends in a ragged 5), `eval`, and `predict --cls-model
    CLIP --seg-model CLIPSeg`; `eval` once more as a `python -m` subprocess.
    $MEDSEG_PROMPT_IDS is unset throughout.  Gates: each command returns,
    finite epoch losses for all four models, exactly one B1 launch a
    `train` step and one B2 a CNN validation and eval batch, none in the
    finetuners, predict's B2 as Pipeline's, the four best .pt strict with
    aux and frozen parts (_ft_checkpoints), both CSVs listing all four,
    card-vs-float64 parity of 3 steps of each recipe (_ft_parity), and no
    synchronization in a steady finetune step.  Readings: each finetune
    step's rate, device split, idle share, operations, GEMM TFLOP/s and
    peak memory.  Returns the launches of its commands."""
    from medseg_tpu_torch.apps import cli
    from medseg_tpu_torch.core.config import CLIPSEG_IMG_SIZE, TrainConfig
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.data.loader import split_train_val
    from medseg_tpu_torch.data.packed import save_packed
    from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg
    from medseg_tpu_torch.eval.harness import load_model_bundle

    cls_ds = synthetic_cls(n=FT_TRAIN_CLS, img_size=SIZE, seed=SEED)
    seg_ds = synthetic_seg(n=FT_TRAIN_SEG, img_size=SIZE, seed=SEED + 1)
    tcfg = TrainConfig()

    def batches(n, frac, b):
        tr, va = split_train_val(n, frac)
        return -(-len(tr) // b), -(-len(va) // b)

    cls_steps, cls_val = batches(FT_TRAIN_CLS, tcfg.val_fraction, tcfg.cls_batch_size)
    seg_steps, seg_val = batches(FT_TRAIN_SEG, tcfg.val_fraction, tcfg.seg_batch_size)
    seg_train = len(split_train_val(FT_TRAIN_SEG, cli.FINETUNE_VAL_FRACTION)[0])
    if seg_train % 8 != 5:
        fail(f"finetune path: CLIPSeg's train split of {seg_train} has no ragged tail of 5")
    env = os.environ.pop("MEDSEG_PROMPT_IDS", None)
    launches = {"warp_affine": 0, "fused_photometric": 0}
    (HERE / "build").mkdir(exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
            root = Path(tmp)
            packed, weights, results = root / "packed", root / "weights", root / "results"
            save_packed(cls_ds, str(packed), "train_cls")
            save_packed(seg_ds, str(packed), "train_seg")
            save_packed(synthetic_cls(n=FT_TEST, img_size=SIZE, seed=SEED + 2), str(packed),
                        "test_cls")
            save_packed(synthetic_seg(n=FT_TEST, img_size=SIZE, seed=SEED + 3), str(packed),
                        "test_seg")
            common = ["--cache-dir", str(packed), "--weights-root", str(weights),
                      "--results-dir", str(results)]
            t0 = time.perf_counter()
            train_b1 = FT_TRAIN_EPOCHS * (cls_steps + seg_steps)
            train_b2 = FT_TRAIN_EPOCHS * (cls_val + seg_val)
            text = _cli(card, ["train", "ResNet18", "ResNetUnet", "--epochs",
                               str(FT_TRAIN_EPOCHS)] + common,
                        {"warp_affine": train_b1, "fused_photometric": train_b2})
            for name in ("ResNet18", "ResNetUnet"):
                _ft_epochs(text, name, FT_TRAIN_EPOCHS)
            if "STAGE 2" not in text or "Training Summary" not in text:
                fail(f"finetune path: train did not cross to stage 2 or print its summary")
            t1 = time.perf_counter()
            text = _cli(card, ["finetune-clip", "--random-init", "--epochs", str(FT_EPOCHS)]
                        + common, {})
            _ft_epochs(text, "CLIP", FT_EPOCHS)
            text = _cli(card, ["finetune-clipseg", "--random-init", "--epochs",
                               str(FT_EPOCHS)] + common, {})
            _ft_epochs(text, "CLIPSeg", FT_EPOCHS)
            t2 = time.perf_counter()
            # the seeded inits, drawn again on the card, and the aux tensors
            clip0, tf = cli.random_init_clip()
            seg0, cond = cli.random_init_clipseg()
            inits = {"CLIP": ({k: v.cpu() for k, v in clip0.state_dict().items()},
                              ("text_features", tf), "vision_model."),
                     "CLIPSeg": ({k: v.cpu() for k, v in seg0.state_dict().items()},
                                 ("cond", cond), "decoder.")}
            del clip0, seg0
            _ft_checkpoints(card, weights, inits)
            eval_b2 = 1 + -(-FT_TEST // 8)  # ResNet18 at B=16, ResNetUnet at B=8
            text = _cli(card, ["eval"] + common, {"fused_photometric": eval_b2})
            for name in ("ResNet18", "ResNetUnet", "CLIP", "CLIPSeg"):
                if f"Weights not found for {name}" in text or f"test {name} " in text:
                    fail(f"finetune path: eval skipped {name}:\n{text}")
            for fname in ("classification_test_results.csv", "segmentation_test_results.csv"):
                with open(results / fname, newline="") as f:
                    models = [r["Model"] for r in csv.DictReader(f)]
                want = (["ResNet18", "CLIP"] if fname.startswith("class")
                        else ["ResNetUnet", "CLIPSeg"])
                if models != want:
                    fail(f"finetune path: {fname} lists {models}, not {want}")
            predict_b2 = _ft_predict(card, root, weights, common)
            launches["warp_affine"] += train_b1
            launches["fused_photometric"] += train_b2 + eval_b2 + predict_b2
            t3 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "medseg_tpu_torch.apps.cli", "eval", "--cache-dir",
                 str(packed), "--weights-root", str(weights), "--results-dir",
                 str(root / "results_subprocess")],
                cwd=HERE, capture_output=True, text=True, timeout=600)
            sub_csv = root / "results_subprocess" / "segmentation_test_results.csv"
            if proc.returncode != 0 or "CLIPSeg" not in sub_csv.read_text():
                fail(f"finetune path: `python -m medseg_tpu_torch.apps.cli eval` exited "
                     f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            print(f"[{card}] finetune path: train {t1 - t0:.1f} s, the two finetunes "
                  f"{t2 - t1:.1f} s, checkpoints + eval + predict {t3 - t2:.1f} s, `python "
                  f"-m medseg_tpu_torch.apps.cli eval` in a subprocess exit 0 in "
                  f"{time.perf_counter() - t3:.1f} s, both CSVs listing all four models")

            faults = []
            print(f"[{card}] finetune path: torch uses {torch.get_num_threads()} CPU threads")
            for name, seg, ds, steady in (("CLIP", False, cls_ds, _ft_clip_steady),
                                          ("CLIPSeg", True, seg_ds, _ft_clipseg_steady)):
                t4 = time.perf_counter()
                state, extra = load_model_bundle(name, str(weights), seg)
                aux = next(iter(extra.values()))
                model = get_model(name)["factory"](device="cuda")
                model.load_state_dict(state, strict=True)
                faults.append(steady(card, model, aux, ds))
                logit = model.logit_size(CLIPSEG_IMG_SIZE) if seg else 0
                del model
                t5 = time.perf_counter()
                _ft_parity(card, name, {k: v.cpu() for k, v in state.items()},
                           aux.cpu().numpy(), ds, logit)
                print(f"[{card}] finetune path, {name}: steady step readings "
                      f"{t5 - t4:.1f} s, card-vs-float64 parity {time.perf_counter() - t5:.1f} s")
            for fault in faults:
                if fault is not None:
                    fail(f"finetune path: a finetune step synchronized with the host:\n"
                         f"{fault}")
    finally:
        if env is not None:
            os.environ["MEDSEG_PROMPT_IDS"] = env
    return launches


DP_BATCH = 32      # dp path (b): ResNet18's global batch at 256px, 16 a rank
DP_SEG_BATCH = 8   # ... ResNetUnet's (the recipe's), 4 a rank
DP_STEPS = 3       # ... ResNet18 steps in float32 and in float64 (ResNetUnet: 1)
DP_EVAL = 13       # ... the sharded eval: 13 test samples, batches of 8 (cls) and 4 (seg)
DP_PERMS = 3       # ... one-process float32 runs on permuted rows: the yardstick
DP_LR = 1e-5       # ... the stage-2 optimizer at this lr (PARITY_LR)
DP_WORLD = 2
DP_EPOCHS = 2      # (a): `train ResNet18 ResNetUnet --data-parallel --epochs 2`
DP_READ_STEPS = 4  # (a): steps in the profiler session of the all-reduce reading
DP_TIMEOUT_S = 600  # (b): the ranks' limit, after which they are killed


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_resnet18(dtype):
    """ResNet18 on the card, init_weights from a card generator seeded SEED
    (the same weights in every process), dropout 0, every parameter
    trainable, the stage-2 optimizer at DP_LR; float64 throughout for a
    float64 dtype."""
    from medseg_tpu_torch.models.resnet import init_weights, resnet18
    from medseg_tpu_torch.train import steps as S

    model = resnet18(dtype=dtype, device="cuda", dropout=0.0)
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    model.to(dtype).train()
    return model, S.build_optimizer(DP_LR, 5e-4, 1.0, list(model.parameters()))


def _dp_rows(array: np.ndarray, group) -> torch.Tensor:
    """This rank's rows of a global host batch on the card (all of them
    without a group)."""
    from medseg_tpu_torch.parallel import shard_batch

    if group is None:
        return torch.from_numpy(np.ascontiguousarray(array)).cuda()
    return shard_batch(array, group)


def _dp_cls_run(group, dtype, perm=None) -> dict:
    """DP_STEPS steps of ResNet18 at 256px on this rank's rows of a global
    batch of DP_BATCH (one process: all of it; the same batch each step),
    each augmented by one B1 launch (float32 out, then `dtype`) with the
    global batch's draws, inside data_parallel(group).  perm: the one
    process's rows permuted after the augmentation, each with its draw.
    Returns the losses, step 1's clipped gradients and the final state, on
    the CPU."""
    from medseg_tpu_torch.data.synthetic import synthetic_cls
    from medseg_tpu_torch.ops.augment import augment_batch
    from medseg_tpu_torch.parallel import data_parallel
    from medseg_tpu_torch.train import steps as S

    ds = synthetic_cls(n=DP_BATCH, img_size=SIZE, seed=SEED + 20)
    images, labels = _dp_rows(ds.images, group), _dp_rows(ds.labels, group)
    model, opt = _dp_resnet18(dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def prep(g, x, y):
        x = augment_batch(g, x, out_dtype=torch.float32)[0].to(dtype)
        return (x, y) if perm is None else (x[perm], y[perm])

    out = {"loss": []}
    with data_parallel(group):
        for i in range(DP_STEPS):
            loss, _ = S.cls_train_step(model, opt, images, labels, gen, 0.1, prep=prep)
            out["loss"].append(loss.item())
            if i == 0:
                out["grads"] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    out["state"] = {k: v.cpu() for k, v in model.state_dict().items()
                    if not k.endswith("num_batches_tracked")}
    return out


def _summary(t: torch.Tensor) -> torch.Tensor:
    """[sum, sum of squares, dot with cos(0, 1, 2, ...)] in float64: what a
    comparison at 1e-9 needs of a large tensor, in 24 bytes."""
    v = t.detach().double().reshape(-1)
    return torch.stack([v.sum(), v.square().sum(),
                        v @ torch.cos(torch.arange(v.numel(), dtype=torch.float64,
                                                   device=v.device))]).cpu()


def _dp_seg_run(group) -> dict:
    """One float64 ResNetUnet step at 256px on this rank's rows of a global
    batch of DP_SEG_BATCH: the encoder frozen, its BatchNorms in training
    (global statistics under a group), the mask riding B1 as its 4th plane.
    Returns the loss and each tensor's _summary (95M float64 parameters)."""
    from medseg_tpu_torch.data.synthetic import synthetic_seg
    from medseg_tpu_torch.models.resnet import init_weights
    from medseg_tpu_torch.models.resnet_unet import resnet_unet
    from medseg_tpu_torch.ops.augment import augment_batch
    from medseg_tpu_torch.parallel import data_parallel
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable

    ds = synthetic_seg(n=DP_SEG_BATCH, img_size=SIZE, seed=SEED + 21)
    model = resnet_unet(dtype=torch.float64, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED + 1))
    model.double().train()
    opt = S.build_optimizer(DP_LR, 5e-4, 1.0, set_trainable(model, finetune_filter("ResNetUnet")))
    with data_parallel(group):
        loss = S.seg_train_step(
            model, opt, _dp_rows(ds.images, group), _dp_rows(ds.masks, group),
            torch.Generator(device="cuda").manual_seed(SEED),
            prep=lambda g, x, m: augment_batch(g, x, m, out_dtype=torch.float64))
    out = {k: _summary(v) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    out.update({f"grad/{k}": _summary(p.grad) for k, p in model.named_parameters()
                if p.grad is not None})
    return {"loss": loss.item(), "summaries": out}


def _dp_eval(argv_tail: list, results: Path) -> str:
    """cli.main(["eval", ...]) in this process, its output captured."""
    import io

    from medseg_tpu_torch.apps import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["eval"] + argv_tail + ["--results-dir", str(results)])
    return buf.getvalue()


def _dp_eval_args(work: Path) -> list:
    return ["--cache-dir", str(work / "packed"), "--weights-root", str(work / "weights"),
            "--batch-size", "8"]


def _dp_rank_main(rank: int, port: int, work: str) -> None:
    """One rank of the dp path's part (b), spawned: joins a gloo group of
    DP_WORLD ranks on cuda:0 through MEDSEG_*, runs the ResNet18 steps in
    float32 and float64, the ResNetUnet float64 step, a best .pt through
    save_best (rank 0 writes) and `eval --data-parallel`; writes its
    results and its B1/B2 launches to WORK/rank{rank}.pt, or its traceback
    to WORK/rank{rank}.err."""
    work = Path(work)
    try:
        import torch.distributed as tdist

        from medseg_tpu_torch.parallel import data_parallel_mesh, initialize_from_env
        from medseg_tpu_torch.train import checkpoint as ckpt

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        os.environ.update(MEDSEG_COORDINATOR=f"127.0.0.1:{port}",
                          MEDSEG_NUM_PROCESSES=str(DP_WORLD), MEDSEG_PROCESS_ID=str(rank))
        initialize_from_env(backend="gloo")
        try:
            group = data_parallel_mesh()
            reset_counts()
            t0 = time.perf_counter()
            out = {"f32": _dp_cls_run(group, torch.float32),
                   "f64": _dp_cls_run(group, torch.float64)}
            out["seg"] = _dp_seg_run(group)
            model, _ = _dp_resnet18(torch.float32)
            ckpt.save_best(str(work / f"weights{rank}"), "ResNet18", model, group=group)
            t1 = time.perf_counter()
            out["eval_log"] = _dp_eval(["--data-parallel"] + _dp_eval_args(work),
                                       work / f"results{rank}")
            out["launches"] = {n: fn.launches for n, fn in kernel_counts().items()}
            out["seconds"] = (t1 - t0, time.perf_counter() - t1)
            out["group"] = (group.rank, group.size, str(group.device))
        finally:
            tdist.destroy_process_group()
        torch.save(out, work / f"rank{rank}.pt")
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _dp_distance(a: dict, b: dict, keys) -> float:
    """The L2 norm of a - b over `keys`, relative to b's."""
    num = sum(float((a[k].double() - b[k].double()).square().sum()) for k in keys)
    den = sum(float(b[k].double().square().sum()) for k in keys)
    return (num / max(den, 1e-300)) ** 0.5


def _dp_f64_gate(card: str, what: str, got: dict, want: dict) -> None:
    """Loss at every step and every parameter and running statistic within
    1e-9 of the float64 reference, relative to each tensor's largest value
    (at least DP_LR: a tensor that starts at 0 may move by AdamW's lr
    alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    worst = max((float((v - want["state"][k]).abs().max())
                 / max(float(want["state"][k].abs().max()), DP_LR), k)
                for k, v in got["state"].items())
    print(f"[{card}] dp path: {what}: losses {got['loss']} vs {want['loss']} (largest "
          f"relative difference {loss:.3g}); parameters and running statistics after "
          f"{DP_STEPS} steps within {worst[0]:.3g} of float64's largest ({worst[1]})")
    if loss > 1e-9 or worst[0] > 1e-9:
        fail(f"dp path: {what}: float64 parity beyond 1e-9 (loss {loss:.3g}, "
             f"{worst[1]} {worst[0]:.3g})")


def _dp_f32_gate(card: str, rank0: dict, perms: list, ref64: dict) -> None:
    """The float32 gate on its yardstick: the two ranks' distance from the
    one-process float64 run within the largest of the permuted one-process
    float32 runs' distances from it, plus the spread of those runs (their
    largest distance from one another); for the losses (largest absolute
    difference over the steps), step 1's clipped gradients and the state
    after the last step (L2, relative)."""
    params = list(ref64["state"])
    grads = list(ref64["grads"])

    def dists(x, y):
        return {"loss": max(abs(a - b) for a, b in zip(x["loss"], y["loss"])),
                "grads": _dp_distance(x["grads"], y["grads"], grads),
                "state": _dp_distance(x["state"], y["state"], params)}

    to64 = [dists(p, ref64) for p in perms]
    spread = [dists(perms[i], perms[j]) for i in range(len(perms))
              for j in range(i + 1, len(perms))]
    got = dists(rank0, ref64)
    for key in ("loss", "grads", "state"):
        bound = max(d[key] for d in to64) + max(d[key] for d in spread)
        print(f"[{card}] dp path, float32 gate: {key}: two ranks {got[key]:.4g} from "
              f"float64; permuted one-process runs {[round(d[key], 10) for d in to64]} "
              f"from it, spread {max(d[key] for d in spread):.4g}; bound {bound:.4g}")
        if got[key] > bound:
            fail(f"dp path: the two ranks' float32 {key} is {got[key]:.4g} from float64, "
                 f"beyond the permuted runs' bound {bound:.4g}")


def _dp_bn_counts(model):
    """Hooks counting the training BatchNorms of a step: forward calls, and
    those whose input needs a gradient (a backward all-reduce each)."""
    from medseg_tpu_torch.nn.blocks import BatchNorm2d

    counts = {"forward": 0, "backward": 0}

    def hook(module, args):
        if module.training:
            counts["forward"] += 1
            counts["backward"] += int(args[0].requires_grad)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm2d)]
    return counts, handles


def _dp_allreduce_reading(card: str, group, name: str, batch: int) -> None:
    """(a): one bf16 train step of `name` at 256px, B=batch, under the NCCL
    world-1 group: its all-reduce launches against the number the design
    implies (a training BatchNorm's forward one, its backward one when its
    input needs a gradient, one gradient bucket), exact.  Readings over
    DP_READ_STEPS steps: the NCCL kernels' device time and their share of
    the step's (NCCL launches no kernel for a world of one), the host time
    inside the all-reduce calls beside the step's host time, and the step's
    device time without the group (native BatchNorm, no collective)."""
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg
    from medseg_tpu_torch.models.resnet import init_weights
    from medseg_tpu_torch.ops.augment import augment_batch
    from medseg_tpu_torch.parallel import data_parallel
    from medseg_tpu_torch.parallel.sharding import COLLECTIVE_COUNTS
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable

    seg = name == "ResNetUnet"
    ds = (synthetic_seg if seg else synthetic_cls)(n=batch, img_size=SIZE, seed=SEED + 22)
    images = torch.from_numpy(ds.images).cuda()
    target = torch.from_numpy(ds.masks if seg else ds.labels).cuda()
    model = get_model(name)["factory"](dtype=torch.bfloat16, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(SEED))
    opt = S.build_optimizer(DP_LR, 5e-4, 1.0, set_trainable(model.train(), finetune_filter(name)))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if seg:
        def step():
            S.seg_train_step(model, opt, images, target, gen, prep=lambda g, x, m: augment_batch(
                g, x, m, out_dtype=torch.bfloat16))
    else:
        def step():
            S.cls_train_step(model, opt, images, target, gen, 0.1, prep=lambda g, x, y: (
                augment_batch(g, x, out_dtype=torch.bfloat16)[0], y))
    with data_parallel(group):
        step()  # warm-up
        counts, handles = _dp_bn_counts(model)
        torch.cuda.synchronize()
        before = COLLECTIVE_COUNTS["all_reduce"]
        step()
        torch.cuda.synchronize()
        got = COLLECTIVE_COUNTS["all_reduce"] - before
        for h in handles:
            h.remove()
        want = counts["forward"] + counts["backward"] + 1
        print(f"[{card}] dp path (a): {name} bf16 B={batch} step under NCCL world 1: "
              f"{got} all-reduce launches; the design's {want} = {counts['forward']} "
              f"training BatchNorm forwards + {counts['backward']} backwards + 1 gradient "
              f"bucket")
        if got != want:
            fail(f"dp path: {name}'s step launched {got} all-reduces, not {want}")
        events = next(_sessions(step, DP_READ_STEPS, 1))
        spent = [0.0]
        call = group.all_reduce_

        def timed(t):
            t0 = time.perf_counter()
            out = call(t)
            spent[0] += time.perf_counter() - t0
            return out

        group.all_reduce_ = timed  # this instance's calls, the BatchNorms' too
        try:
            with host_clock():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DP_READ_STEPS):
                    step()
                torch.cuda.synchronize()
                host = (time.perf_counter() - t0) / DP_READ_STEPS * 1e3
        finally:
            del group.all_reduce_
    plain = next(_sessions(step, DP_READ_STEPS, 1))
    with host_clock():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_READ_STEPS):
            step()
        torch.cuda.synchronize()
        plain_host = (time.perf_counter() - t0) / DP_READ_STEPS * 1e3
    nccl = [e for e in events if "nccl" in e.key.lower()]
    total = sum(e.device_time_total for e in events) / DP_READ_STEPS / 1e3
    ms = sum(e.device_time_total for e in nccl) / DP_READ_STEPS / 1e3
    n = sum(e.count for e in nccl) / DP_READ_STEPS
    in_calls = spent[0] / DP_READ_STEPS * 1e3
    print(f"[{card}] dp path (a): {name} bf16 B={batch}: NCCL kernels {n:g} a step "
          f"({sorted({e.key[:48] for e in nccl})}), {ms:.4f} ms of {total:.3f} ms of device "
          f"time a step ({100 * ms / total:.2f}%); host time in the all-reduce calls "
          f"{in_calls:.3f} ms of a {host:.3f} ms step ({100 * in_calls / host:.1f}%); the "
          f"same step without the group (native BatchNorm, no collective) "
          f"{sum(e.device_time_total for e in plain) / DP_READ_STEPS / 1e3:.3f} ms of device "
          f"time, {plain_host:.3f} ms of host")


def _dp_csvs_close(card: str, what: str, got: Path, want: Path) -> None:
    """Both results CSVs of `got` equal those of `want`: the same rows and
    models, every number within rel 1e-4."""
    for fname in ("classification_test_results.csv", "segmentation_test_results.csv"):
        with open(got / fname, newline="") as f:
            a = list(csv.reader(f))
        with open(want / fname, newline="") as f:
            b = list(csv.reader(f))
        if len(a) != len(b) or any(len(x) != len(y) or x[0] != y[0] for x, y in zip(a, b)):
            fail(f"dp path: {what}: {fname} differs in shape or models:\n{a}\n{b}")
        worst = 0.0
        for x, y in zip(a[1:], b[1:]):
            for u, v in zip(x[1:], y[1:]):
                worst = max(worst, abs(float(u) - float(v)) / max(abs(float(v)), 1e-12))
        if worst > 1e-4:
            fail(f"dp path: {what}: {fname} differs by rel {worst:.3g}")
        print(f"[{card}] dp path: {what}: {fname} ({len(a) - 1} models) within rel "
              f"{worst:.3g} of one process's")


def run_dp_path(card: str) -> dict:
    """Data parallelism on the one card.  (a) NCCL world 1 in this process
    (MEDSEG_* with one process): the all-reduce launches of a ResNet18 and
    a ResNetUnet bf16 step against the design's count, and the all-reduce
    share of each step (a reading); then through cli.main on the finetune
    path's synthetic caches `train ResNet18 ResNetUnet --data-parallel
    --epochs 2` (one B1 a step, one B2 a validation batch), `eval
    --data-parallel` against `eval` (the CSVs within rel 1e-4) and
    `finetune-clipseg --data-parallel --random-init --epochs 1`.  (b) two
    ranks on cuda:0 under gloo, spawned while (a) runs: ResNet18 at 256px,
    global B=32, 3 float32 steps (TF32 off) and 3 float64 steps,
    ResNetUnet's float64 step, a save_best and `eval --data-parallel` of 13
    samples (ragged tails); each rank exactly 7 B1 and 6 B2.  Gates: float64
    within 1e-9 of one process on the global batch (the two ranks, and in
    (a) the world-1 step against the plain one); float32 on the permuted
    runs' yardstick (_dp_f32_gate); the sharded eval's CSVs within rel 1e-4
    of one process's; only rank 0 wrote.  Returns the launches of (a)'s
    commands and (b)'s ranks."""
    import multiprocessing

    import torch.distributed as tdist

    from medseg_tpu_torch.apps import cli
    from medseg_tpu_torch.core.config import TrainConfig
    from medseg_tpu_torch.data.loader import split_train_val
    from medseg_tpu_torch.data.packed import save_packed
    from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg
    from medseg_tpu_torch.models.resnet import init_weights, resnet18
    from medseg_tpu_torch.models.resnet_unet import resnet_unet
    from medseg_tpu_torch.parallel import data_parallel_mesh, initialize_from_env

    t_start = time.perf_counter()
    launches = {"warp_affine": 0, "fused_photometric": 0}
    keys = ("MEDSEG_COORDINATOR", "MEDSEG_NUM_PROCESSES", "MEDSEG_PROCESS_ID")
    saved_env = {k: os.environ.pop(k, None) for k in keys}
    prompt_ids = os.environ.pop("MEDSEG_PROMPT_IDS", None)
    ranks = []
    (HERE / "build").mkdir(exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
            work = Path(tmp)
            packed = work / "packed"
            # the finetune path's caches, and (b)'s 13-sample test split
            save_packed(synthetic_cls(n=FT_TRAIN_CLS, img_size=SIZE, seed=SEED), str(packed),
                        "train_cls")
            save_packed(synthetic_seg(n=FT_TRAIN_SEG, img_size=SIZE, seed=SEED + 1),
                        str(packed), "train_seg")
            save_packed(synthetic_cls(n=DP_EVAL, img_size=SIZE, seed=SEED + 2), str(packed),
                        "test_cls")
            save_packed(synthetic_seg(n=DP_EVAL, img_size=SIZE, seed=SEED + 3), str(packed),
                        "test_seg")
            weights = work / "weights"
            for name, factory, sub in (("ResNet18_best_acc", resnet18, "classification_models"),
                                       ("ResNetUnet_best_loss", resnet_unet,
                                        "segmentation_models")):
                model = factory(device="cuda")
                init_weights(model, torch.Generator(device="cuda").manual_seed(SEED + 3))
                (weights / sub).mkdir(parents=True, exist_ok=True)
                torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                           weights / sub / f"{name}.pt")
            del model

            # (a) NCCL world 1 in this process, as a one-process job joins
            os.environ.update(MEDSEG_COORDINATOR=f"127.0.0.1:{_free_port()}",
                              MEDSEG_NUM_PROCESSES="1", MEDSEG_PROCESS_ID="0")
            if not initialize_from_env():
                fail("dp path: initialize_from_env did not join under MEDSEG_*")
            nccl = data_parallel_mesh()
            print(f"[{card}] dp path (a): {nccl} on the {tdist.get_backend()} backend")
            t0 = time.perf_counter()
            _dp_allreduce_reading(card, nccl, "ResNet18", TrainConfig().cls_batch_size)
            _dp_allreduce_reading(card, nccl, "ResNetUnet", TrainConfig().seg_batch_size)
            t1 = time.perf_counter()

            # (b) the two ranks start while the card works on (a)
            port = _free_port()
            ctx = multiprocessing.get_context("spawn")
            ranks = [ctx.Process(target=_dp_rank_main, args=(r, port, str(work)), daemon=True)
                     for r in range(DP_WORLD)]
            for p in ranks:
                p.start()

            common = ["--cache-dir", str(packed), "--weights-root", str(work / "trained")]
            tcfg = TrainConfig()
            n_cls = len(split_train_val(FT_TRAIN_CLS, tcfg.val_fraction)[0])
            n_seg = len(split_train_val(FT_TRAIN_SEG, tcfg.val_fraction)[0])
            b1 = DP_EPOCHS * (n_cls // tcfg.cls_batch_size + n_seg // tcfg.seg_batch_size)
            b2 = DP_EPOCHS * (-(-(FT_TRAIN_CLS - n_cls) // tcfg.cls_batch_size)
                              + -(-(FT_TRAIN_SEG - n_seg) // tcfg.seg_batch_size))
            text = _cli(card, ["train", "ResNet18", "ResNetUnet", "--data-parallel", "--epochs",
                               str(DP_EPOCHS)] + common,
                        {"warp_affine": b1, "fused_photometric": b2}, path="dp path")
            for name in ("ResNet18", "ResNetUnet"):
                rows = _epoch_lines(text.splitlines(), f"dp path, {name}", FT_EPOCH_LINES[name])
                if [r[0] for r in rows] != list(range(1, DP_EPOCHS + 1)):
                    fail(f"dp path: {name} logged epochs {[r[0] for r in rows]}")
            for line in ("[INFO] multi-host: process 0/1", "[INFO] data-parallel over 1 devices"):
                if line not in text:
                    fail(f"dp path: `train --data-parallel` did not print {line!r}")
            for f in ("ResNet18_resume.pt", "ResNetUnet_resume.pt"):
                if not list((work / "trained").rglob(f)):
                    fail(f"dp path: `train --data-parallel` wrote no {f}")
            launches["warp_affine"] += b1
            launches["fused_photometric"] += b2
            b2_eval = -(-DP_EVAL // 8) + -(-DP_EVAL // 4)
            eval_args = _dp_eval_args(work)
            _cli(card, ["eval", "--data-parallel"] + eval_args
                 + ["--results-dir", str(work / "results_dp")],
                 {"fused_photometric": b2_eval}, path="dp path")
            _cli(card, ["eval"] + eval_args + ["--results-dir", str(work / "results_one")],
                 {"fused_photometric": b2_eval}, path="dp path")
            launches["fused_photometric"] += 2 * b2_eval
            _dp_csvs_close(card, "(a) `eval --data-parallel` under NCCL world 1",
                           work / "results_dp", work / "results_one")
            text = _cli(card, ["finetune-clipseg", "--data-parallel", "--random-init",
                               "--epochs", "1"] + common, {}, path="dp path")
            _ft_epochs(text, "CLIPSeg", 1)
            t2 = time.perf_counter()

            # one process on the global batch, while the ranks run
            ref64 = _dp_cls_run(None, torch.float64)
            _dp_f64_gate(card, "(a) ResNet18 float64, the world-1 data-parallel step "
                         "(NCCL) against the plain one", _dp_cls_run(nccl, torch.float64),
                         ref64)
            perms = [_dp_cls_run(None, torch.float32, perm=torch.from_numpy(
                np.random.default_rng(SEED + 30 + i).permutation(DP_BATCH)).cuda())
                for i in range(DP_PERMS)]
            seg64 = _dp_seg_run(None)
            t3 = time.perf_counter()
            # until both are done, one fails (its peer would wait in a
            # collective) or the limit passes
            while (any(p.is_alive() for p in ranks)
                   and all(p.exitcode in (None, 0) for p in ranks)
                   and time.perf_counter() - t1 < DP_TIMEOUT_S):
                time.sleep(0.2)
            for r, p in enumerate(ranks):
                err = work / f"rank{r}.err"
                if p.exitcode != 0 or err.exists():
                    fail(f"dp path (b): rank {r} exited {p.exitcode}:\n"
                         f"{err.read_text() if err.exists() else '(no traceback)'}")
            t4 = time.perf_counter()
            got = [torch.load(work / f"rank{r}.pt", weights_only=False)
                   for r in range(DP_WORLD)]
            _dp_check_ranks(card, got, work, ref64, perms, seg64)
            for n in launches:
                launches[n] += sum(g["launches"][n] for g in got)
            print(f"[{card}] dp path: (a)'s readings {t1 - t0:.1f} s, its commands "
                  f"{t2 - t1:.1f} s; one-process references {t3 - t2:.1f} s; waited "
                  f"{t4 - t3:.1f} s for the ranks (steps {[round(g['seconds'][0], 1) for g in got]}"
                  f" s, eval {[round(g['seconds'][1], 1) for g in got]} s); "
                  f"{time.perf_counter() - t_start:.1f} s in all")
    finally:
        for p in ranks:
            if p.pid is not None:  # started
                p.kill()
                p.join(10)
        if tdist.is_initialized():
            tdist.destroy_process_group()
        for k, v in saved_env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        if prompt_ids is not None:
            os.environ["MEDSEG_PROMPT_IDS"] = prompt_ids
    return launches


def _dp_check_ranks(card: str, got: list, work: Path, ref64: dict, perms: list,
                    seg64: dict) -> None:
    """(b)'s gates on the ranks' results (see run_dp_path)."""
    b1 = 2 * DP_STEPS + 1
    b2 = -(-DP_EVAL // 8) + -(-DP_EVAL // 4)
    for r, g in enumerate(got):
        if g["group"] != (r, DP_WORLD, "cuda:0"):
            fail(f"dp path (b): rank {r} was {g['group']}")
        want = {"warp_affine": b1, "fused_photometric": b2, "stem_conv_pool": 0}
        if g["launches"] != want:
            fail(f"dp path (b): rank {r} launched {g['launches']}, expected {want}")
    print(f"[{card}] dp path (b): each of {DP_WORLD} gloo ranks on cuda:0 launched "
          f"{got[0]['launches']}: one B1 a train step ({2 * DP_STEPS} ResNet18 + 1 "
          f"ResNetUnet), one B2 an eval batch")
    r0, r1 = got
    for key in ("f32", "f64"):
        same = r0[key]["loss"] == r1[key]["loss"] and all(
            torch.equal(v, r1[key]["state"][k]) for k, v in r0[key]["state"].items())
        if not same:
            fail(f"dp path (b): the two ranks' {key} ResNet18 runs differ")
    _dp_f64_gate(card, f"(b) ResNet18 float64, {DP_WORLD} gloo ranks of B={DP_BATCH // 2} "
                 f"against one process of B={DP_BATCH}", r0["f64"], ref64)
    _dp_f32_gate(card, r0["f32"], perms, ref64)
    loss = abs(r0["seg"]["loss"] - seg64["loss"]) / abs(seg64["loss"])
    s0, s1, one = r0["seg"]["summaries"], r1["seg"]["summaries"], seg64["summaries"]
    # gradients relative to the largest gradient's summary; the rest to their
    # own, but for the parameters whose gradient is noise within 1e-9 of it
    # (a conv bias feeding a BatchNorm has an exactly zero one), held apart:
    # they start at 0 and move by AdamW's response to rounding noise alone
    gmax = max(float(v.abs().max()) for k, v in one.items() if k.startswith("grad/"))
    noise = [k for k in one if k.startswith("grad/")
             and float(one[k].abs().max()) <= 1e-9 * gmax]
    apart = {k[5:] for k in noise}
    worst = max((float((s0[k] - v).abs().max())
                 / (gmax if k.startswith("grad/") else max(float(v.abs().max()), 1e-300)), k)
                for k, v in one.items() if k not in apart)
    print(f"[{card}] dp path (b): ResNetUnet float64 step, {DP_WORLD} ranks of "
          f"B={DP_SEG_BATCH // 2} against one process of B={DP_SEG_BATCH}: loss "
          f"{r0['seg']['loss']} vs {seg64['loss']} (rel {loss:.3g}); every tensor's summary "
          f"within {worst[0]:.3g} ({worst[1]}); {len([k for k in one if k.startswith('grad/')])} "
          f"gradients, none in the encoder; held apart, their gradients noise: "
          f"{sorted(apart)}")
    if (loss > 1e-9 or worst[0] > 1e-9 or s0.keys() != s1.keys()
            or any(not torch.equal(v, s1[k]) for k, v in s0.items())
            or any(k.startswith("grad/encoder") for k in one)):
        fail("dp path (b): ResNetUnet's float64 step is not one process's within 1e-9, "
             "or the ranks differ")
    if not (work / "weights0" / "ResNet18_best_acc.pt").exists() \
            or (work / "weights1").exists() or (work / "results1").exists():
        fail("dp path (b): save_best and the eval CSVs must be rank 0's alone")
    _dp_csvs_close(card, f"(b) `eval --data-parallel` over {DP_WORLD} gloo ranks, "
                   f"{DP_EVAL} samples", work / "results0", work / "results_one")


INGEST_PER_CLASS = 100  # ingest path: 299x299 PNGs a class (the Kaggle set's size)
INGEST_UNMASKED = 5     # ... the last of each class have no mask
INGEST_MASK = 256       # ... masks at 256x256, as the Kaggle set's lung masks
INGEST_EPOCHS = 2       # `train ResNet18 ResNetUnet --epochs 2 --profile DIR`
INGEST_PROBES = ((299, 299), (128, 200), (200, 128), (64, 64))  # native vs cv2


def _ingest_tree(root: Path) -> dict:
    """The dataset's PNG tree: dataset/<class>/images/<class>-<i>.png, X-ray
    textured 299x299 RGB, each class its own brightness; masks at
    INGEST_MASK, a random ellipse of 255 on 0, for all but the last
    INGEST_UNMASKED images of a class.  Returns {id: class}."""
    import cv2

    from medseg_tpu_torch.core.config import CLASSES

    rng = np.random.default_rng(SEED)
    ids = {}
    for k, cls in enumerate(CLASSES):
        (root / cls / "images").mkdir(parents=True)
        (root / cls / "masks").mkdir(parents=True)
        for i in range(INGEST_PER_CLASS):
            img = np.clip(_xray_like(rng, 299, 299).astype(np.int16) + 30 * (k - 1), 0, 255)
            cv2.imwrite(str(root / cls / "images" / f"{cls}-{i}.png"), img.astype(np.uint8))
            ids[f"{cls}-{i}"] = cls
            if i < INGEST_PER_CLASS - INGEST_UNMASKED:
                mask = np.zeros((INGEST_MASK, INGEST_MASK), np.uint8)
                cy, cx = rng.integers(80, 176, 2)
                ry, rx = rng.integers(30, 70, 2)
                y, x = np.mgrid[0:INGEST_MASK, 0:INGEST_MASK]
                mask[((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1.0] = 255
                cv2.imwrite(str(root / cls / "masks" / f"{cls}-{i}.png"), mask)
    return ids


def _ingest_splits(card: str, root: Path, ids: dict) -> dict:
    """The split CSVs partition the tree 80/10/10, stratified: returns
    {split: [(id, class), ...]} in file order."""
    from medseg_tpu_torch.core.config import CLASSES

    rows = {}
    for split in ("train", "val", "test"):
        with open(root / "splits" / f"{split}.csv", newline="") as f:
            reader = csv.reader(f)
            if next(reader) != ["id", "class"]:
                fail(f"ingest path: {split}.csv's header is not id,class")
            rows[split] = [tuple(r) for r in reader]
    seen = [r[0] for part in rows.values() for r in part]
    want = {"train": 0.8, "val": 0.1, "test": 0.1}
    counts = {split: {c: sum(r[1] == c for r in part) for c in CLASSES}
              for split, part in rows.items()}
    if (sorted(seen) != sorted(ids) or any(ids[i] != c for part in rows.values()
                                           for i, c in part)
            or any(n != round(want[split] * INGEST_PER_CLASS)
                   for split, per in counts.items() for n in per.values())):
        fail(f"ingest path: the split CSVs do not partition the tree 80/10/10 by class: "
             f"{counts}")
    print(f"[{card}] ingest path, split: {len(rows['train'])}/{len(rows['val'])}/"
          f"{len(rows['test'])} rows, {counts['train']} / {counts['val']} / "
          f"{counts['test']} by class, every id once")
    return rows


def _ingest_packed(card: str, root: Path, packed: Path, rows: dict) -> None:
    """The six caches `pack` wrote: shapes, labels in the CSVs' order (seg:
    only rows with a mask), masks of 0 and 255 only."""
    from medseg_tpu_torch.core.config import CLASSES, IMG_SIZE
    from medseg_tpu_torch.data.packed import load_packed

    for split, part in rows.items():
        for task in ("cls", "seg"):
            ds = load_packed(str(packed), f"{split}_{task}", mmap=False)
            keep = [(i, c) for i, c in part
                    if task == "cls" or (root / c / "masks" / f"{i}.png").exists()]
            labels = [CLASSES.index(c) for _, c in keep]
            n = len(keep)
            ok = (ds.images.shape == (n, IMG_SIZE, IMG_SIZE, 3) and ds.images.dtype == np.uint8
                  and ds.labels.tolist() == labels and ds.labels.dtype == np.int32)
            if task == "seg":
                ok = ok and ds.masks.shape == (n, IMG_SIZE, IMG_SIZE) and \
                    set(np.unique(ds.masks).tolist()) <= {0, 255}
            else:
                ok = ok and ds.masks is None
            if not ok:
                fail(f"ingest path: {split}_{task} holds {ds.images.shape} images, labels "
                     f"{ds.labels[:8]}..., masks "
                     f"{None if ds.masks is None else ds.masks.shape}; want {n} rows")


def _native_against_cv2(card: str, root: Path, work: Path) -> str:
    """Which route packs, and the native loader held against cv2 when it
    built (tests/test_native_loader.py's tolerances): bilinear within 1 of
    cv2's float resize, the letterbox's pad zero, nearest masks of 0 and
    255 with under 1% of pixels apart from cv2's, on probe PNGs of
    INGEST_PROBES; and the train split packed by both routes: images within
    1, masks of 0 and 255 under 1% apart."""
    import cv2

    from medseg_tpu_torch.core.config import DataConfig
    from medseg_tpu_torch.data.packed import pack_split
    from medseg_tpu_torch.native import loader

    if not loader.available():
        import io

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            loader.build(verbose=True)
        why = " | ".join(out.getvalue().strip().splitlines()[:2])
        print(f"[{card}] ingest path: the native loader did not build (g++ at "
              f"{shutil.which('g++')}: {why or 'no output'}): `pack` took the cv2 route")
        return "cv2"
    rng = np.random.default_rng(SEED + 1)
    paths, arrays = [], []
    for k, (h, w) in enumerate(INGEST_PROBES):
        arr = rng.integers(0, 256, (h, w, 3), np.uint8)
        paths.append(str(work / f"probe{k}.png"))
        cv2.imwrite(paths[-1], arr[:, :, ::-1])
        arrays.append(arr)
    out = loader.decode_resize_batch(paths, 256, letterbox=False, gray=False)
    worst = max(float(np.abs(out[k].astype(np.float32) - cv2.resize(
        a.astype(np.float32), (256, 256), interpolation=cv2.INTER_LINEAR)).max())
        for k, a in enumerate(arrays))
    boxed = loader.decode_resize_batch(paths, 256, letterbox=True, gray=False)
    pads = []
    for k, a in enumerate(arrays):
        h, w = a.shape[:2]
        nh, nw = round(h * 256 / max(h, w)), round(w * 256 / max(h, w))
        top, left = (256 - nh) // 2, (256 - nw) // 2
        inside = np.zeros((256, 256), bool)
        inside[top:top + nh, left:left + nw] = True
        pads.append(int(boxed[k][~inside].max()) if (~inside).any() else 0)
    mask = (rng.random((299, 299)) > 0.5).astype(np.uint8) * 255
    cv2.imwrite(str(work / "probe_mask.png"), mask)
    near = loader.decode_resize_batch([str(work / "probe_mask.png")], 256, letterbox=False,
                                      gray=True, nearest=True)[0]
    apart = float((near != cv2.resize(mask, (256, 256),
                                      interpolation=cv2.INTER_NEAREST)).mean())
    cfg = DataConfig(root=str(root), splits_dir=str(root / "splits"))
    split_diff, mask_apart = 0.0, 0.0
    for task in ("cls", "seg"):
        a = pack_split(cfg, "train", task, use_native=True)
        b = pack_split(cfg, "train", task, use_native=False)
        split_diff = max(split_diff, float(np.abs(a.images.astype(np.int16)
                                                  - b.images.astype(np.int16)).max()))
        if task == "seg":
            mask_apart = float((a.masks != b.masks).mean())
            if not set(np.unique(a.masks).tolist()) <= {0, 255}:
                fail("ingest path: the native route's masks hold values other than 0, 255")
    ok = (worst <= 1.01 and max(pads) == 0 and apart < 0.01
          and set(np.unique(near).tolist()) <= {0, 255} and split_diff <= 1.0
          and mask_apart < 0.01)
    print(f"[{card}] ingest path, native loader ({loader.library_path().name}) vs cv2 "
          f"{cv2.__version__}: bilinear max |diff| {worst:.2f} (tol 1.01) over "
          f"{INGEST_PROBES}; letterbox pad max {max(pads)} (tol 0); nearest mask "
          f"{apart:.4%} apart (tol 1%); the train split packed by both routes: images "
          f"max |diff| {split_diff:.0f} (tol 1), masks {mask_apart:.4%} apart (tol 1%): "
          f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("ingest path: the native loader is not within tolerance of cv2")
    return "native"


@_on_host_clock
def _pack_rates(card: str, root: Path, route: str) -> None:
    """A reading: img/s of packing all six caches (images and masks decoded
    and resized) by each route the machine has, host clock."""
    from medseg_tpu_torch.core.config import DataConfig
    from medseg_tpu_torch.data.packed import pack_split

    cfg = DataConfig(root=str(root), splits_dir=str(root / "splits"))
    rates = []
    routes = (("native", True), ("cv2", False)) if route == "native" else (("cv2", False),)
    for name, native in routes:
        t0 = time.perf_counter()
        n = sum(len(pack_split(cfg, split, task, use_native=native))
                for split in ("train", "val", "test") for task in ("cls", "seg"))
        dt = time.perf_counter() - t0
        rates.append(f"{name} {n / dt:.1f} img/s ({n} samples in {dt:.3f} s)")
    print(f"[{card}] ingest path, pack of the six caches at 256px by host clock, "
          f"{os.cpu_count()} CPUs: " + "; ".join(rates))


def _trace_launches(card: str, trace_dir: Path, steps: dict) -> None:
    """The `--profile` traces: one Chrome trace per model, each naming the
    warp kernel once per train step of that model's run."""
    files = sorted(trace_dir.glob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)
    counts = []
    for f in files:
        events = json.loads(f.read_text())["traceEvents"]
        counts.append(sum(1 for e in events if e.get("cat") == "kernel"
                          and "warp_affine_kernel" in e.get("name", "")))
    want = list(steps.values())
    size = sum(f.stat().st_size for f in files) / 2**20
    print(f"[{card}] ingest path, --profile: {len(files)} trace(s), {size:.1f} MiB, "
          f"warp kernels {counts} (want {want}, one a train step of "
          f"{', '.join(steps)})")
    if counts != want:
        fail(f"ingest path: the --profile traces name the warp kernel {counts} times, "
             f"not once a step {want}")


def _ingest_compare(card: str, packed: Path, weights: Path, work: Path, common: list,
                    eval_b2: int) -> int:
    """`eval`, then `eval --compare REF` against copies of its CSVs (delta 0,
    within tolerance) and against a copy with one metric moved by 1 pp
    (caught); then `parity --reference` with both (exit 0, exit 1).  Each
    command launches B2 eval_b2 times; returns their launches."""
    from medseg_tpu_torch.eval.parity import compare_results_csv

    names = ("classification_test_results.csv", "segmentation_test_results.csv")
    base = ["--cache-dir", str(packed), "--weights-root", str(weights)] + common
    _cli(card, ["eval", "--results-dir", str(work / "r0")] + base,
         {"fused_photometric": eval_b2}, "ingest path")
    ref, moved = work / "ref", work / "ref_moved"
    for d in (ref, moved):
        d.mkdir()
        for n in names:
            shutil.copy(work / "r0" / n, d / n)
    with open(moved / names[0], newline="") as f:
        table = list(csv.reader(f))
    table[1][1] = repr(float(table[1][1]) - 1.0)  # the first model's accuracy
    with open(moved / names[0], "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(table)
    for d, same in ((ref, True), (moved, False)):
        text = _cli(card, ["eval", "--results-dir", str(work / f"r_{d.name}"), "--compare",
                           str(d)] + base, {"fused_photometric": eval_b2}, "ingest path")
        heads = [f"=== Parity vs {d / n} ===" for n in names]
        verdicts = [line for line in text.splitlines() if line.startswith("max |delta|")]
        want = (["max |delta| = 0.000 pp; within tolerance: True"] * 2 if same else
                ["max |delta| = 1.000 pp; within tolerance: False",
                 "max |delta| = 0.000 pp; within tolerance: True"])
        deltas = [compare_results_csv(str(work / f"r_{d.name}" / n), str(d / n))
                  ["max_abs_delta"] for n in names]
        if not all(h in text for h in heads) or verdicts != want:
            fail(f"ingest path: eval --compare {d.name} read {verdicts}, not {want}")
        print(f"[{card}] ingest path, eval --compare {d.name}: {verdicts}; exact max "
              f"|delta| {deltas}")
        text = _cli(card, ["parity", "--reference", str(d), "--results-dir",
                           str(work / f"p_{d.name}")] + base, {"fused_photometric": eval_b2},
                    "ingest path", code=0 if same else 1)
        verdict = "PARITY PASS" if same else "PARITY FAIL"
        if text.rstrip().splitlines()[-1] != verdict:
            fail(f"ingest path: parity --reference {d.name} did not end in {verdict}")
    return 5 * eval_b2  # 3 `eval` and 2 `parity`


@_on_host_clock
def _ingest_demo(card: str, weights: Path, work: Path) -> None:
    """`demo --builtin --no-warmup` as a `python -m` subprocess over the
    trained weights: GET / and /design.css are the port's page and
    stylesheet, POST /predict with one 299x299 PNG answers a class and a
    confidence; the process is stopped in every case."""
    import base64
    import io
    import socket

    from PIL import Image

    from medseg_tpu_torch.apps.demo import CSS, builtin_demo_page
    from medseg_tpu_torch.core.config import CLASSES

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log = open(work / "demo.log", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "medseg_tpu_torch.apps.cli", "demo", "--builtin",
         "--no-warmup", "--port", str(port), "--weights-root", str(weights)],
        cwd=HERE, stdout=log, stderr=subprocess.STDOUT)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.perf_counter() + 180
        while True:
            try:
                with urllib.request.urlopen(base + "/", timeout=10) as r:
                    page = r.read()
                break
            except OSError:
                if proc.poll() is not None or time.perf_counter() > deadline:
                    fail(f"ingest path: the demo did not come up (exit {proc.poll()}):\n"
                         f"{(work / 'demo.log').read_text()[-3000:]}")
                time.sleep(0.5)
        up = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/design.css", timeout=10) as r:
            css = r.read()
        if page != builtin_demo_page().encode() or css != CSS.encode():
            fail("ingest path: the demo's page or stylesheet is not the port's")
        buf = io.BytesIO()
        Image.fromarray(_xray_like(np.random.default_rng(SEED + 2), 299, 299)).save(
            buf, format="PNG")
        t1 = time.perf_counter()
        out = _post(port, json.dumps({"image": base64.b64encode(buf.getvalue()).decode()})
                    .encode(), timeout=300)
        first = time.perf_counter() - t1
        t1 = time.perf_counter()
        again = _post(port, json.dumps({"image": base64.b64encode(buf.getvalue()).decode()})
                      .encode(), timeout=300)
        second = time.perf_counter() - t1
        if (out["prediction"] not in CLASSES or not 0.0 < out["confidence"] <= 100.0
                or again["prediction"] != out["prediction"]):
            fail(f"ingest path: the demo's /predict answered {out}")
        print(f"[{card}] ingest path, `python -m medseg_tpu_torch.apps.cli demo --builtin "
              f"--no-warmup` over the trained weights: up in {up:.1f} s, GET / and "
              f"/design.css are the port's page and CSS ({len(page)} + {len(css)} bytes), "
              f"POST /predict (299x299 PNG) -> {out['prediction']} "
              f"{out['confidence']:.2f}% in {first:.3f} s (models loaded), again in "
              f"{second:.3f} s (host clock)")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()


def run_ingest_path(card: str) -> dict:
    """From the dataset's PNGs to a trained model, its parity report and the
    demo, through medseg_tpu_torch.apps.cli.main in this process as a user
    runs it: a PNG tree of 3 classes x INGEST_PER_CLASS 299x299 X-ray-like
    images (masks at 256x256, none for the last INGEST_UNMASKED of a class),
    `split`, `pack` (the native C++ loader when it builds, else cv2), `train
    ResNet18 ResNetUnet --epochs 2 --profile DIR` at full width, `eval`,
    `eval --compare` and `parity --reference` against copies of its own
    CSVs and against a copy with one metric moved by 1 pp, and `demo
    --builtin` as a `python -m` subprocess.  Gates: the CSVs partition the
    tree 240/30/30 stratified; the caches' shapes and labels; the native
    route against cv2; exactly one B1 launch a train step and one B2 a
    validation, eval and parity batch, counted from the sizes; the traces
    name the warp kernel once a step; the reports read delta 0 and PASS on
    the copy and catch the moved metric (parity exits 0 and 1); the demo's
    page and CSS are the port's and /predict answers.  Readings: pack img/s
    by route, each command's wall time.  Returns the launches of its
    commands."""
    from medseg_tpu_torch.core.config import TrainConfig
    from medseg_tpu_torch.data.loader import split_train_val
    from medseg_tpu_torch.data.packed import load_packed

    cfg = TrainConfig()
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        work = Path(tmp)
        root, packed, weights = work / "dataset", work / "packed", work / "weights"
        t0 = time.perf_counter()
        ids = _ingest_tree(root)
        print(f"[{card}] ingest path: wrote {len(ids)} PNGs at 299x299 and their masks in "
              f"{time.perf_counter() - t0:.1f} s")
        _cli(card, ["split", "--root", str(root)], {}, "ingest path")
        rows = _ingest_splits(card, root, ids)
        _cli(card, ["pack", "--root", str(root), "--cache-dir", str(packed)], {},
             "ingest path")
        _ingest_packed(card, root, packed, rows)
        route = _native_against_cv2(card, root, work)
        _pack_rates(card, root, route)

        def batches(n, frac, b):
            tr, va = split_train_val(n, frac)
            return -(-len(tr) // b), -(-len(va) // b)

        n_cls = len(load_packed(str(packed), "train_cls").labels)
        n_seg = len(load_packed(str(packed), "train_seg").labels)
        cls_steps, cls_val = batches(n_cls, cfg.val_fraction, cfg.cls_batch_size)
        seg_steps, seg_val = batches(n_seg, cfg.val_fraction, cfg.seg_batch_size)
        train_b1 = INGEST_EPOCHS * (cls_steps + seg_steps)
        train_b2 = INGEST_EPOCHS * (cls_val + seg_val)
        trace = work / "trace"
        text = _cli(card, ["train", "ResNet18", "ResNetUnet", "--epochs", str(INGEST_EPOCHS),
                           "--cache-dir", str(packed), "--weights-root", str(weights),
                           "--profile", str(trace)],
                    {"warp_affine": train_b1, "fused_photometric": train_b2}, "ingest path")
        for name in ("ResNet18", "ResNetUnet"):
            _ft_epochs(text, name, INGEST_EPOCHS)
        _trace_launches(card, trace, {"ResNet18": INGEST_EPOCHS * cls_steps,
                                      "ResNetUnet": INGEST_EPOCHS * seg_steps})
        n_test = {t: len(load_packed(str(packed), f"test_{t}").labels) for t in ("cls", "seg")}
        eval_b2 = -(-n_test["cls"] // 16) + -(-n_test["seg"] // 8)
        compare_b2 = _ingest_compare(card, packed, weights, work, ["--root", str(root)],
                                     eval_b2)
        _ingest_demo(card, weights, work)
    return {"warp_affine": train_b1, "fused_photometric": train_b2 + compare_b2}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import medseg_tpu_torch

    if Path(medseg_tpu_torch.__file__).resolve().parents[1] != HERE:
        print("chip_smoke: run it from the root of a checkout", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    card = card_label()
    print(f"device: torch={name!r} nvidia-smi={card!r} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    global _WORKER
    t_start = time.perf_counter()
    _WORKER = _CpuWorker()  # starts its interpreter while the kernels build
    try:
        code = _drive(card, name)
    finally:
        _WORKER.close()
        _WORKER = None
    print(f"[{card}] chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return code


def _drive(card: str, name: str) -> int:
    """Builds and checks the kernels, drives every path and prints the
    kernels line; fails on any phase's failure."""
    from medseg_tpu_torch.ops.kernels import build, photometric, stem_kernel, warp_kernel

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[{card}] kernel build: {time.perf_counter() - t0:.3f} s for "
          f"{len(libs)} source(s), all started together")
    for src, lib in libs.items():
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    t0 = time.perf_counter()
    records = {"warp_affine": check_warp_kernel(card),
               "fused_photometric": check_photometric_kernel(card),
               "stem_conv_pool": check_stem_kernel(card)}
    _zoo_kernel_checks(card)
    _clip_kernel_checks(card)
    # each kernel's launches on the path that runs it at the recorded shape
    launches = {"warp_affine": run_main_path(card)["warp_affine"],
                "fused_photometric": run_eval_path(card)["fused_photometric"],
                "stem_conv_pool": run_stem_path(card)["stem_conv_pool"]}
    print(f"[{card}] kernel checks and the aug+infer, eval and stem paths: "
          f"{time.perf_counter() - t0:.1f} s")
    paths = {"ingest": run_ingest_path, "train": run_train_path, "seg": run_seg_path,
             "serve": run_serve_path, "clip": run_clip_path, "finetune": run_finetune_path,
             "dp": run_dp_path, "zoo": run_zoo_path}
    returned = {}
    for path, run in paths.items():
        t0 = time.perf_counter()
        returned[path] = run(card)
        print(f"[{card}] {path} path: {time.perf_counter() - t0:.1f} s")
    # B2's count: the eval path's launches and the clip path's servers'; and
    # both kernels' launches on the ingest, finetune and dp paths' commands
    # (the dp path's two ranks' too)
    launches["fused_photometric"] += returned["clip"]
    for path in ("ingest", "finetune", "dp"):
        for kernel, n in returned[path].items():
            launches[kernel] += n

    modules = {"warp_affine": warp_kernel, "fused_photometric": photometric,
               "stem_conv_pool": stem_kernel}
    kernels = [dict(name=name, route="cuda",
                    source="medseg_tpu_torch/csrc/" + module.SOURCE,
                    replaces=module.REPLACES, launches=launches[name],
                    **records[name]) for name, module in modules.items()]
    for k in kernels:
        if k["launches"] < 1:
            fail(f"kernel {k['name']} was not launched on its path")
    _WORKER.drain(card)
    print(json.dumps({"kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
