#!/usr/bin/env python3
"""The spread of chip_smoke.py's gate-4 yardstick for one model of its
seg or zoo recipes, on one GPU.

    python3 gate4_spread.py [--model AttentionUNet] [--seeds 8] [--threads 8,4,2,1]

Gate 4 holds the card's float32 train steps against float64 on the CPU,
within a multiple of the CPU float32 run's own distance from float64.
For each seed this script makes random full-width weights and a random
64px batch of 2 (augmented by B1 on the card), then runs chip_smoke's
three float32 steps (TF32 off) twice on the card and once in float64 on
the card, the same steps in float64 on the CPU, and in float32 on the CPU
at each thread count given (each count sums in another order).  For the
step-1 clipped gradients, the parameters after step 3 and the running
statistics it prints each run's distance from the CPU's float64 (largest
element and L2), the CPU's spread over its orders, and the card's
distance over the first order's and over the largest of the orders that
chip_smoke.py takes (its CPU threads and those at YARDSTICK_THREADS'
fractions).  The card's name and power limit come first.  It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

import chip_smoke as C


def l2(ts) -> float:
    return math.sqrt(sum(float(t.double().square().sum()) for t in ts))


def dist(a, b, pick):
    """(largest element, L2) of run a's distance from run b over pick's tensors."""
    ta, tb = pick(a), pick(b)
    d = [ta[n].double() - tb[n].double() for n in tb]
    return max(float(x.abs().max()) for x in d), l2(d)


PARTS = {
    "step-1 gradients": lambda r: r[1],
    "parameters after step 3": lambda r: {n: r[2][n] for n in r[1]},
    "running statistics": lambda r: {k: v for k, v in r[2].items()
                                     if k.endswith(("running_mean", "running_var"))},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="AttentionUNet", choices=C.ZOO_SEG + C.ZOO_CLS)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--threads", default="8,4,2,1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gate4_spread: no CUDA device is available", file=sys.stderr)
        return 1
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.ops.augment import augment_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.card_label()
    print(f"card: {card}")
    threads = [int(t) for t in args.threads.split(",")]
    gate = {threads[0] // d or 1 for d in (1, *C.YARDSTICK_THREADS)}
    seg = args.model in C.ZOO_SEG
    for seed in range(args.seeds):
        t0 = time.perf_counter()
        torch.manual_seed(seed)
        model = get_model(args.model)["factory"](dtype=torch.float32, device="cpu")
        state = {k: v.clone() for k, v in model.state_dict().items()}
        rng = np.random.default_rng(seed)
        images = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)).cuda()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if seg:
            masks = torch.from_numpy((rng.random((2, 64, 64)) > 0.5).astype(np.uint8))
            x, y = augment_batch(gen, images, masks.cuda())
        else:
            x, y = augment_batch(gen, images)[0], torch.from_numpy(rng.integers(0, 3, 2))
        x, y = x.cpu(), y.cpu()
        recipe = C._zoo_recipe(args.model, state)
        card_runs = [C._parity_run(*recipe, x, y, "cuda", torch.float32) for _ in range(2)]
        card64 = C._parity_run(*recipe, x, y, "cuda", torch.float64)
        ref = C._parity_run(*recipe, x, y, "cpu", torch.float64)
        cpus = {t: C._cpu_order_run(*recipe, x, y, t) for t in threads}
        lines = [f"[{card}] {args.model} seed {seed} ({time.perf_counter() - t0:.0f} s)"]
        for part, pick in PARTS.items():
            if not pick(ref):
                continue
            cm, cl = dist(card_runs[0], ref, pick)
            rm, rl = dist(card_runs[1], ref, pick)
            m64 = dist(card64, ref, pick)[0]
            cpu = {t: dist(r, ref, pick) for t, r in cpus.items()}
            first = cpu[threads[0]]
            worst = [max(cpu[t][i] for t in gate if t in cpu) for i in (0, 1)]
            mx = [v[0] for v in cpu.values()]
            lines.append(
                f"  {part}: card max {cm:.3e} L2 {cl:.3e} (rerun {rm:.3e}/{rl:.3e}; float64 "
                f"card vs CPU max {m64:.1e}) | " + " ".join(
                    f"cpu{t} {v[0]:.3e}/{v[1]:.3e}" for t, v in cpu.items())
                + f" | CPU orders' largest/smallest max {max(mx) / min(mx):.2f} | card over "
                f"cpu{threads[0]} max {cm / first[0]:.2f} L2 {cl / first[1]:.2f}; over the "
                f"largest of cpu{sorted(gate, reverse=True)} max {cm / worst[0]:.2f} "
                f"L2 {cl / worst[1]:.2f}")
        print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
