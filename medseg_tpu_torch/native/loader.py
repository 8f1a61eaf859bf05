"""ctypes bindings for the native C++ PNG decode/resize loader.

Counterpart of medseg_tpu/native/loader.py over a copy of its source
(native/loader.cpp).  The packed cache makes decoding a one-time cost, and
this loader makes that one-time cost fast: a C++ thread pool decodes PNGs
with libpng and resizes (bilinear half-pixel / nearest, cv2's conventions)
straight into the caller's pre-allocated numpy buffer.

It is host code, not a device kernel.  The library is built at first use
(`available()` or `build()`) with g++ and libpng into build/medseg_tpu_torch/
at the root of the checkout, named by a hash of its source, its flags and
what -march=native means on the host, as the CUDA kernels are named
(ops/kernels/build.py); it is written under a temporary name and renamed
into place, so processes that build it at once never load half a file.
Without g++ or libpng's headers nothing is built and `available()` is
False: `pack_split` then takes the cv2 route.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np

SOURCE = Path(__file__).with_name("loader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "medseg_tpu_torch"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-lz", "-lpthread")

_lib = None
_build_failed = False


@functools.lru_cache(maxsize=None)
def _native_target() -> str:
    """The target options that -march=native stands for on this host, as
    g++ reports them: part of the library's name, so that a library built
    for another CPU is never loaded here."""
    try:
        return subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                              capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS + LIBS).encode()
                            + _native_target().encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmedseg_loader-{digest}.so"


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    lib.decode_resize_batch.restype = ctypes.c_int
    lib.decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.c_int,  # n
        ctypes.c_void_p,  # out buffer
        ctypes.c_int,  # out size (square)
        ctypes.c_int,  # channels (1 or 3)
        ctypes.c_int,  # letterbox flag
        ctypes.c_int,  # nearest flag
        ctypes.c_int,  # num threads
    ]
    _lib = lib
    return lib


def build(verbose: bool = False) -> bool:
    """Compile loader.cpp into build/medseg_tpu_torch/ unless it is there
    already (g++ + libpng); returns success."""
    out = library_path()
    if out.exists():
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        res = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp, *LIBS],
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            if verbose:
                print(res.stderr)
            return False
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        return True
    except (OSError, subprocess.SubprocessError) as e:
        if verbose:
            print(e)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def available() -> bool:
    """Whether the library loads, building it at the first call of the
    process that finds it missing."""
    global _build_failed
    if _load() is None and not _build_failed:
        _build_failed = not build()
    return _load() is not None


def decode_resize_batch(paths: Sequence[str], size: int, *, letterbox: bool,
                        gray: bool, nearest: bool = False,
                        threads: int | None = None) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader not built; call loader.build()")
    n = len(paths)
    ch = 1 if gray else 3
    shape = (n, size, size) if gray else (n, size, size, 3)
    out = np.zeros(shape, np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    nthreads = threads or min(16, os.cpu_count() or 1)
    rc = lib.decode_resize_batch(
        arr, n, out.ctypes.data_as(ctypes.c_void_p), size, ch,
        int(letterbox), int(nearest), nthreads)
    if rc != 0:
        raise RuntimeError(f"native decode failed on {rc - 1}: {paths[rc - 1]}")
    return out
