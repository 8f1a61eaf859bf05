"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in medseg_tpu_torch/csrc/ is compiled on first use into a shared
library with a plain C interface, under build/medseg_tpu_torch/ at the root
of the checkout.  The library's name carries a hash of its source and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing is compiled while a module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "medseg_tpu_torch"
# Every kernel source of the port; chip_smoke.py builds them all at once.
SOURCES = ("warp_affine.cu", "photometric.cu", "stem_conv_pool.cu")
# -fmad=false: no multiply-add contraction, so the kernels repeat their plain
# PyTorch versions' float32 arithmetic exactly (a kernel that wants fused
# multiply-adds, as the stem's conv does, calls fmaf explicitly).  -Xptxas -v: report each
# kernel's registers, shared memory and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Library:
    cdll: ctypes.CDLL
    log: str  # nvcc and ptxas output of the build ("" if an earlier one was loaded)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit")
    return path


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> Library:
    """Build csrc/<source> if needed and load it (cached per process)."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        log = proc.stdout + proc.stderr
    return Library(ctypes.CDLL(str(out)), log)


def build_all(sources: Sequence[str] = SOURCES) -> Dict[str, Library]:
    """Build every source with one nvcc each, all started together."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return dict(zip(sources, pool.map(load_library, sources)))
