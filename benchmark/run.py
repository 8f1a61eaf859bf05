#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (medseg_tpu_torch) on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json (a configuration under a traffic mix) on
the cards of this machine: set-up (inputs and weights made from the seed
on the card, every shape of the cell warmed, the first steps read for the
check), a window of --seconds (--trace 1: the mix's shorter traced window
under the profiler), then the comparison with the plain reference, and
prints the result as the last line of standard output: with --trace 0 the
cell's end-to-end metrics, with --trace 1 its per-layer ones.  It exits
non-zero, printing no result, without enough CUDA devices, when the port
it imports is not this checkout's, or when JAX or the JAX package was
loaded.  Build, kernel and bytecode caches stay inside the checkout (build/).
"""

from __future__ import annotations

import time

T_START = time.time()  # the process's start, as near as Python gets to it

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "benchmark" / sub)
os.environ["USE_FLAX"] = "0"  # a library that would load JAX by itself
# Compiled bytecode, torch's included, is kept inside the checkout: where the
# installed packages carry none and the environment writes none, every run
# would compile torch's sources anew (some 12 s of set-up, varying with the
# host's load).  Only the first run in a checkout writes it.
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import manifest, runner

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA devices, found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    import medseg_tpu_torch

    port = Path(medseg_tpu_torch.__file__).resolve()
    if ROOT not in port.parents:
        print(f"benchmark: medseg_tpu_torch comes from {port}, not from this checkout",
              file=sys.stderr)
        return 2
    driver = manifest.driver(cell.traffic["driver"])
    result = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), T_START)
    return runner.emit(result)


if __name__ == "__main__":
    sys.exit(main())
