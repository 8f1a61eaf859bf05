#!/usr/bin/env python3
"""Smoke run of the PyTorch port (medseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It
1. prints the card (torch's name, and nvidia-smi's name and power limit);
2. builds every CUDA kernel of the port from medseg_tpu_torch/csrc/;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with the tolerance stated per case;
4. drives the main path at full width: a synthetic packed set at 256px,
   BatchLoader(device_cache=True), augment_batch (one warp-kernel launch
   with the photometric epilogue) -> ResNet18 bf16 forward -> argmax ->
   classification_metrics, and checks that every kernel of the path was
   launched, that the logits are finite and that the bf16 forward agrees
   with a float32 forward of the same weights;
5. prints one JSON line with every kernel's launches, error and times, and
   as its last line {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when there is no card, when it is
not run from a checkout, or when any phase fails.  It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

BATCH = 128          # main-path batch
SIZE = 256           # IMG_SIZE
N_SAMPLES = 1024     # 8 batches of 128
SEED = 0


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def warp_bound_ms(b: int, h: int, w: int, c: int, out_bytes: int):
    """Least time for the warp on this card: each uint8 input byte read and
    each output written once, against the 16-tap weighted sum each output
    value needs (16 multiply-adds = 32 flops) plus the epilogue's 4, in
    float32 outside the tensor cores.  Returns (ms, "bytes"|"operations")."""
    values = b * h * w * c
    t_bytes = (values * (1 + out_bytes) + b * 8 * 4) / HBM_BYTES_PER_S
    t_ops = values * (32 + 4) / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_warp_kernel(card: str):
    """The warp kernel against its plain version in four forms; returns the
    main-path form's record (error and times)."""
    from medseg_tpu_torch.core.config import AugmentConfig, IMAGENET_MEAN, IMAGENET_STD
    from medseg_tpu_torch.ops.augment import _combined_matrices, sample_augment_params
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
    cases.append(("bilinear C=3 epilogue bf16 (main path)", imgs, mats, main_kw,
                  2.0 ** -6, "one bf16 ulp at the output's largest magnitude (|x| < 4)"))
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
    main_err = None
    for name, x, m, kw, tol, why in cases:
        got = warp_affine_kernel(x, m, **kw)
        torch.cuda.synchronize()
        want = warp_affine_fast(x, m, **kw)
        err = (got.float() - want.float()).abs().max().item()
        print(f"[{card}] warp kernel vs plain, {name}: max_abs_err={err} "
              f"tol={tol} ({why})")
        if not err <= tol:
            fail(f"warp kernel disagrees with its plain version ({name}): "
                 f"{err} > {tol}")
        if main_err is None:
            main_err = err

    ms = cuda_ms(lambda: warp_affine_kernel(imgs, mats, **main_kw), reps=50)
    plain_ms = cuda_ms(lambda: warp_affine_fast(imgs, mats, **main_kw), reps=5)
    bound_ms, bound_by = warp_bound_ms(BATCH, SIZE, SIZE, 3, out_bytes=2)
    print(f"[{card}] warp kernel B={BATCH} {SIZE}x{SIZE}x3 u8->bf16 with "
          f"epilogue: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); no single PyTorch call "
          f"computes this two-pass warp, so library_ms is null")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def run_main_path(card: str):
    """The fused aug+infer path at full width; returns the launches seen."""
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.synthetic import synthetic_cls
    from medseg_tpu_torch.eval.metrics import classification_metrics
    from medseg_tpu_torch.models.resnet import resnet18
    from medseg_tpu_torch.ops.augment import augment_batch
    from medseg_tpu_torch.ops.kernels.warp_kernel import warp_affine_kernel

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

        warp_affine_kernel.launches = 0
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
        launches = warp_affine_kernel.launches
        n_batches = len(aug_ms)

        if launches != n_batches:
            fail(f"warp kernel launched {launches} times for {n_batches} batches")
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
    return {"warp_affine": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import medseg_tpu_torch
    from medseg_tpu_torch.ops.kernels import build, warp_kernel

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

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[{card}] kernel build: {time.perf_counter() - t0:.3f} s for "
          f"{len(libs)} source(s), all started together")
    for src, lib in libs.items():
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    record = check_warp_kernel(card)
    launches = run_main_path(card)

    kernels = [dict(name="warp_affine", route="cuda",
                    source="medseg_tpu_torch/csrc/" + warp_kernel.SOURCE,
                    replaces=warp_kernel.REPLACES,
                    launches=launches["warp_affine"], **record)]
    for k in kernels:
        if k["launches"] < 1:
            fail(f"kernel {k['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
