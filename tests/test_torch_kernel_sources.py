"""The CUDA sources themselves, on the CPU: each csrc/*.cu is built with g++
against tests/cuda_emulation.h (threads of a block as std::threads) and
called through its wrapper's own CUDA branch, on CPU tensors, against
the kernel's plain PyTorch version.  This checks each kernel's indexing,
tiling, borders and layouts here; only the chip run shows that nvcc builds
it and that it is right and fast on the card."""

import functools
import math
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from medseg_tpu_torch.core.config import AugmentConfig, IMAGENET_MEAN, IMAGENET_STD
from medseg_tpu_torch.ops.augment import (_combined_matrices, envelope_edge_matrices,
                                          sample_augment_params)
from medseg_tpu_torch.ops.kernels import build
from medseg_tpu_torch.ops.kernels import photometric as P
from medseg_tpu_torch.ops.kernels import stem_kernel as S
from medseg_tpu_torch.ops.kernels import warp_kernel as W
from medseg_tpu_torch.ops.warp_fast import MAX_SHIFT, PAD, warp_affine_fast, warp_scalars

torch.set_num_threads(1)

HEADER = Path(__file__).resolve().parent / "cuda_emulation.h"
LAUNCH = re.compile(r"(\w+(?:<[^;(]*?>)?)<<<(.*?)>>>\((.*?)\);", re.S)
DYNAMIC_SHARED = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{source: ctypes launcher} for every kernel source, built with g++.
    -ffp-contract=off stands for nvcc's -fmad=false."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernel sources on the CPU")
    out = tmp_path_factory.mktemp("cuda_emulation")
    libs = {}
    for source in build.SOURCES:
        text = (build.CSRC / source).read_text()
        text = LAUNCH.sub(lambda m: f"EmuLaunch({m.group(2)})"
                                    f"([&] {{ {m.group(1)}({m.group(3)}); }});", text)
        text = re.sub(r"#include <cuda_(bf16|runtime)\.h>", "", text)
        text = DYNAMIC_SHARED.sub(r"\1* \2 = reinterpret_cast<\1*>(emu_dynamic_smem);",
                                  text)
        cpp = out / (source + ".cpp")
        cpp.write_text(f'#include "{HEADER}"\n{text}')
        lib = out / f"lib{Path(source).stem}.so"
        proc = subprocess.run(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
             "-pthread", "-Wall", "-Wno-unknown-pragmas", "-o", str(lib), str(cpp)],
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        libs[source] = lib
    return libs


def _run(module, emulated, monkeypatch):
    """The wrapper's own CUDA branch (checks, packing, allocation and its
    launcher's argument types), bound to the emulated build instead of
    nvcc's and called on CPU tensors with stream 0."""
    import ctypes

    monkeypatch.setattr(build, "load_library", lambda source: build.Library(
        ctypes.CDLL(str(emulated[source])), ""))
    return functools.partial(module._run, module._launcher.__wrapped__(), None)


@functools.lru_cache(maxsize=None)
def _warp_inputs(channels, size=24, b=2):
    gen = torch.Generator().manual_seed(channels)
    images = torch.randint(0, 256, (b, size, size, channels), generator=gen,
                           dtype=torch.uint8)
    p = sample_augment_params(gen, b, AugmentConfig(affine_p=1.0, hflip_p=0.5))
    return images, _combined_matrices(p, size, size), p


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_warp_source_equals_plain_version(emulated, monkeypatch, out_dtype, planar):
    """With the epilogue, NHWC or planar, float32 or bf16: bit for bit."""
    run = _run(W, emulated, monkeypatch)
    images, mats, p = _warp_inputs(3)
    kw = dict(out_dtype=out_dtype, alpha=p.alpha, beta=p.beta, planar=planar,
              mean=tuple(m * 255.0 for m in IMAGENET_MEAN),
              std=tuple(s * 255.0 for s in IMAGENET_STD))
    assert torch.equal(run(images, mats, nearest=False, **kw),
                       warp_affine_fast(images, mats, **kw))


@pytest.mark.parametrize("channels,nearest", [(1, True), (4, False)])
def test_warp_source_without_epilogue(emulated, monkeypatch, channels, nearest):
    run = _run(W, emulated, monkeypatch)
    images, mats, _ = _warp_inputs(channels)
    assert torch.equal(run(images, mats, nearest, torch.float32, None, None, None,
                           None, False),
                       warp_affine_fast(images, mats, nearest=nearest))


def _epilogue_kw(b, out_dtype, planar=False, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return dict(out_dtype=out_dtype, planar=planar,
                alpha=0.9 + 0.2 * torch.rand(b, generator=gen),
                beta=0.2 * torch.rand(b, generator=gen) - 0.1,
                mean=tuple(m * 255.0 for m in IMAGENET_MEAN),
                std=tuple(s * 255.0 for s in IMAGENET_STD))


def _images(b, h, w, c=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, h, w, c), generator=gen, dtype=torch.uint8)


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("size", [(40, 72), (40, 80), (33, 37)],
                         ids=["byte-rows", "16-byte-rows", "odd-pitch"])
def test_warp_source_on_ragged_tiles(emulated, monkeypatch, size, planar):
    """Several 64x64 tiles, the last row and column of tiles cut short:
    source rows staged byte by byte (40x72x3), in 16-byte loads (40x80x3),
    and an odd width whose output pitch rules out 16-byte stores."""
    run = _run(W, emulated, monkeypatch)
    h, w = size
    images = _images(3, h, w)
    p = sample_augment_params(torch.Generator().manual_seed(3), 3,
                              AugmentConfig(affine_p=1.0, hflip_p=0.5))
    mats = _combined_matrices(p, h, w)
    for out_dtype in (torch.float32, torch.bfloat16):
        kw = _epilogue_kw(3, out_dtype, planar)
        assert torch.equal(run(images, mats, nearest=False, **kw),
                           warp_affine_fast(images, mats, **kw))


@pytest.mark.parametrize("size", [(72, 136), (64, 176)],
                         ids=["byte-rows", "16-byte-rows"])
@pytest.mark.parametrize("nearest", [False, True])
def test_warp_source_at_the_envelope_edge(emulated, monkeypatch, nearest, size):
    """Source rows wider than the staged window (384 bytes), so each tile
    stages the columns it reads, folded at the image's edges."""
    run = _run(W, emulated, monkeypatch)
    h, w = size
    images = _images(4, h, w, seed=4)
    mats = envelope_edge_matrices(h, w)
    kw = _epilogue_kw(4, torch.bfloat16, seed=4)
    assert torch.equal(run(images, mats, nearest, **kw),
                       warp_affine_fast(images, mats, nearest=nearest, **kw))


def _rows_pass_b_reads(matrices, h, w, tile_w=64, tile_h=64):
    """The most padded rows that pass B reads for one output tile, by the
    plain version's formulas (float64: a premise, not a bit-exact check)."""
    worst = 0
    for aa, cc, bb, m11, m12p, m10 in warp_scalars(matrices).double().tolist():
        mid_col = (w + 2 * PAD - 1) / 2.0
        kb = lambda x: math.floor(min(max(m10 * (x + PAD - mid_col) / m11,
                                          1.0 - MAX_SHIFT), MAX_SHIFT - 1.0))
        for x0 in range(0, w, tile_w):
            ks = (kb(x0), kb(min(x0 + tile_w, w) - 1))
            for y0 in range(0, h, tile_h):
                y1 = min(y0 + tile_h, h) - 1
                src = [m11 * (y0 + PAD + min(ks)) + m12p + m10 * mid_col,
                       m11 * (y1 + PAD + max(ks) + 1) + m12p + m10 * mid_col]
                lo = max(math.floor(min(src)), 0)
                hi = min(math.floor(max(src)) + 1, h + 2 * PAD - 1)
                worst = max(worst, hi - lo + 1)
    return worst


def test_warp_source_when_line_shifts_clip(emulated, monkeypatch):
    """Matrices far outside the augmentation envelope: a strong shear whose
    per-column shifts clip at MAX_SHIFT, and a 2.5x vertical minification.
    A tile then reads more padded rows than the kernel stages (96), and the
    rest are computed straight from the image."""
    run = _run(W, emulated, monkeypatch)
    h, w = 64, 136
    mats = torch.tensor([[[1.0, 0.0, 0.0], [0.9, 1.0, -20.0]],
                         [[0.8, 0.3, 5.0], [-0.2, 2.5, -40.0]]])
    assert _rows_pass_b_reads(mats, h, w) > 96
    images = _images(2, h, w, seed=5)
    for nearest in (False, True):
        kw = _epilogue_kw(2, torch.float32, seed=5)
        assert torch.equal(run(images, mats, nearest, **kw),
                           warp_affine_fast(images, mats, nearest=nearest, **kw))


def _photometric_scalars(b, seed):
    gen = torch.Generator().manual_seed(seed)
    alpha = 0.9 + 0.2 * torch.rand(b, generator=gen)
    beta = 0.2 * torch.rand(b, generator=gen) - 0.1
    flip = torch.arange(b) % 2 == 0
    return alpha, beta, flip


def _photometric_norm(c):
    """ImageNet's constants for C=3; others of the same scale for C=1, 4."""
    return {1: ((0.5,), (0.25,)), 3: (IMAGENET_MEAN, IMAGENET_STD),
            4: (IMAGENET_MEAN + (0.0,), IMAGENET_STD + (1.0 / 255.0,))}[c]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_photometric_source_equals_plain_version(emulated, monkeypatch, out_dtype):
    """Flips, alpha and beta per sample, an odd width (the scalar path):
    bit for bit."""
    run = _run(P, emulated, monkeypatch)
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (3, 10, 37, 3), generator=gen, dtype=torch.uint8)
    alpha = 0.9 + 0.2 * torch.rand(3, generator=gen)
    beta = 0.2 * torch.rand(3, generator=gen) - 0.1
    flip = torch.tensor([True, False, True])
    assert torch.equal(
        run(images, alpha, beta, flip, out_dtype, IMAGENET_MEAN, IMAGENET_STD),
        P.fused_photometric_reference(images, alpha, beta, flip, out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("shape", [(3, 6, 48), (2, 9, 256)], ids=["w48", "w256"])
def test_photometric_source_vector_path(emulated, monkeypatch, shape, channels,
                                        out_dtype):
    """W a multiple of 8, aligned tensors: the vector path with its
    shared-memory stage, flipped and unflipped samples, bit for bit.  Both
    shapes end a sample inside a warp (36 and 288 runs of 8 pixels), and
    the second inside a CTA."""
    run = _run(P, emulated, monkeypatch)
    b, h, w = shape
    images = _images(b, h, w, channels, seed=w + channels)
    alpha, beta, flip = _photometric_scalars(b, seed=channels)
    mean, std = _photometric_norm(channels)
    assert torch.equal(run(images, alpha, beta, flip, out_dtype, mean, std),
                       P.fused_photometric_reference(images, alpha, beta, flip,
                                                     out_dtype, mean, std))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_photometric_source_misaligned_input(emulated, monkeypatch, out_dtype):
    """A contiguous view one byte into its storage, W a multiple of 8: the
    scalar path, bit for bit."""
    run = _run(P, emulated, monkeypatch)
    b, h, w, c = 3, 4, 32, 3
    images = torch.empty(b * h * w * c + 1, dtype=torch.uint8)[1:].view(b, h, w, c)
    images.copy_(_images(b, h, w, c, seed=7))
    assert images.data_ptr() % 16 != 0
    alpha, beta, flip = _photometric_scalars(b, seed=7)
    assert torch.equal(
        run(images, alpha, beta, flip, out_dtype, IMAGENET_MEAN, IMAGENET_STD),
        P.fused_photometric_reference(images, alpha, beta, flip, out_dtype))


@pytest.mark.parametrize("width", [48, 37], ids=["vector-path", "scalar-path"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_photometric_source_eval_form(emulated, monkeypatch, out_dtype, width):
    """alpha, beta and flip None (null pointers): the plain version's eval
    form, and the explicit alpha=1, beta=0, no-flip form, bit for bit."""
    run = _run(P, emulated, monkeypatch)
    images = _images(3, 6, width, seed=width)
    got = run(images, None, None, None, out_dtype, IMAGENET_MEAN, IMAGENET_STD)
    assert torch.equal(got, P.fused_photometric_reference(images, None, None, None,
                                                          out_dtype))
    explicit = (torch.ones(3), torch.zeros(3), torch.zeros(3, dtype=torch.bool))
    assert torch.equal(got, run(images, *explicit, out_dtype, IMAGENET_MEAN,
                                IMAGENET_STD))


@pytest.mark.parametrize("shape", [(2, 32, 32), (1, 64, 40), (3, 36, 68), (3, 44, 72)],
                         ids=["one-tile", "2x2-tiles", "ragged-tiles",
                              "ragged-tiles-16-byte-rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_source_equals_plain_version(emulated, monkeypatch, shape, dtype):
    """Whole, several and ragged 8x8 pooled tiles (H/4 or W/4 not a multiple
    of 8) and an odd batch, with the bf16 patch staged element by element
    (W not a multiple of 8) and in 16-byte loads.  float32: within 1e-4 (summation order).
    bf16: one bf16 ulp of the larger magnitude, plus 1e-5 where the float32
    sums straddle ReLU's zero."""
    run = _run(S, emulated, monkeypatch)
    b, h, w = shape
    gen = torch.Generator().manual_seed(h * w)
    planes = torch.randn(b, 3 * h, w, generator=gen).to(dtype)
    weight = (torch.randn(64, 3, 7, 7, generator=gen) * 0.1).to(dtype)
    bias = (torch.randn(64, generator=gen) * 0.1).to(dtype)
    got = run(planes, weight, bias).float()
    want = S.stem_conv_pool_reference(planes, weight, bias).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert ((got - want).abs() <= ulp + 1e-5).all()


def test_stem_source_borders_on_a_constant_image(emulated, monkeypatch):
    run = _run(S, emulated, monkeypatch)
    gen = torch.Generator().manual_seed(2)
    weight = torch.randn(64, 3, 7, 7, generator=gen) * 0.1
    bias = torch.randn(64, generator=gen) * 0.1
    planes = torch.ones(2, 96, 32)
    torch.testing.assert_close(run(planes, weight, bias),
                               S.stem_conv_pool_reference(planes, weight, bias),
                               atol=1e-4, rtol=0)


def test_stem_source_borders_on_a_constant_bf16_image(emulated, monkeypatch):
    """The tensor-core form at every border: a constant-1 image, ragged."""
    run = _run(S, emulated, monkeypatch)
    gen = torch.Generator().manual_seed(3)
    weight = (torch.randn(64, 3, 7, 7, generator=gen) * 0.1).to(torch.bfloat16)
    bias = (torch.randn(64, generator=gen) * 0.1).to(torch.bfloat16)
    planes = torch.ones(1, 3 * 40, 48, dtype=torch.bfloat16)
    got = run(planes, weight, bias).float()
    want = S.stem_conv_pool_reference(planes, weight, bias).float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert ((got - want).abs() <= ulp + 1e-5).all()
