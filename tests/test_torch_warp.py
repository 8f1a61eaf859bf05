"""Warp parity: the port's affine builders, the warp kernel's plain version
and the exact warp against the JAX package on the same numpy inputs."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from medseg_tpu.core.config import IMAGENET_MEAN, IMAGENET_STD
from medseg_tpu.ops import image as JI
from medseg_tpu.ops.pallas.warp_kernel import warp_affine_pallas
from medseg_tpu.ops.warp_fast import warp_affine_fast as jax_warp_fast
from medseg_tpu_torch.ops import image as TI
from medseg_tpu_torch.ops.warp_fast import warp_affine_fast

torch.set_num_threads(1)

SIZE = 48


def _ssr_params(rng, n):
    return [rng.uniform(-15, 15, n), rng.uniform(0.95, 1.05, n),
            rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n)]


def _matrices(rng, n, size=SIZE, flip=None):
    """Default-envelope dst->src matrices, built by the JAX package."""
    p = [jnp.asarray(x.astype(np.float32)) for x in _ssr_params(rng, n)]
    mats = JI.shift_scale_rotate_matrix(*p, size, size)
    if flip is not None:
        f = jnp.where(jnp.asarray(flip)[:, None, None],
                      JI.hflip_matrix(size), JI.identity_affine((n,)))
        mats = JI.compose_affine(mats, f)
    return np.array(mats)  # a writable copy for torch.from_numpy


def test_affine_builders_match_jax():
    """float32 tolerance: both compute the same float32 expressions (they
    agree bitwise here; the tolerance allows an ulp of libm difference)."""
    rng = np.random.default_rng(0)
    p = [x.astype(np.float32) for x in _ssr_params(rng, 6)]
    ssr_j = np.asarray(JI.shift_scale_rotate_matrix(*map(jnp.asarray, p), 40, 56))
    ssr_t = TI.shift_scale_rotate_matrix(*map(torch.from_numpy, p), 40, 56)
    np.testing.assert_allclose(ssr_t.numpy(), ssr_j, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(TI.hflip_matrix(56).numpy(),
                                  np.asarray(JI.hflip_matrix(56)))
    np.testing.assert_array_equal(TI.identity_affine((3,)).numpy(),
                                  np.asarray(JI.identity_affine((3,))))
    b = np.asarray(JI.identity_affine((6,))) + rng.normal(0, 0.1, (6, 2, 3)).astype(np.float32)
    comp_j = np.asarray(JI.compose_affine(jnp.asarray(ssr_j), jnp.asarray(b)))
    comp_t = TI.compose_affine(torch.from_numpy(ssr_j.copy()), torch.from_numpy(b))
    np.testing.assert_allclose(comp_t.numpy(), comp_j, rtol=1e-6, atol=1e-5)


def test_normalize_imagenet_matches_jax():
    x = np.random.default_rng(1).integers(0, 256, (2, 8, 8, 3), np.uint8)
    want = np.asarray(JI.normalize_imagenet(jnp.asarray(x), IMAGENET_MEAN, IMAGENET_STD))
    got = TI.normalize_imagenet(torch.from_numpy(x), IMAGENET_MEAN, IMAGENET_STD)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _fast_reference(nearest: bool):
    """JAX's warp_affine_fast on a 4-channel batch, compiled once per mode;
    the warp treats channels independently, so C=1 and C=3 are slices."""
    rng = np.random.default_rng(int(nearest))
    n = 3
    imgs = rng.integers(0, 256, (n, SIZE, SIZE, 4), np.uint8)
    mats = _matrices(rng, n, flip=np.array([False, True, True]))
    want = np.asarray(jax_warp_fast(jnp.asarray(imgs), jnp.asarray(mats),
                                    nearest=nearest))
    return imgs, mats, want


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("nearest", [False, True])
def test_plain_warp_matches_warp_affine_fast(channels, nearest):
    """atol 0.01 gray: XLA on the CPU may contract multiply-adds into FMAs
    (the same delta tests/test_pallas_kernels.py:64-69 allows); nearest
    copies source pixels and must be exact."""
    imgs, mats, want = _fast_reference(nearest)
    imgs = np.ascontiguousarray(imgs[..., :channels])
    want = want[..., :channels]
    got = warp_affine_fast(torch.from_numpy(imgs), torch.from_numpy(mats),
                           nearest=nearest).numpy()
    if nearest:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=0.01)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_plain_warp_epilogue_matches_pallas_interpret(out_dtype):
    """The kernel's function with the fused epilogue, against the Pallas
    kernel run in interpret mode.  float32: 1e-4 after normalization (the
    0.01-gray FMA delta over a std of ~57 gray).  bfloat16: one bf16 ulp
    plus that 1e-4, since the delta can move a value across a rounding
    boundary."""
    rng = np.random.default_rng(5)
    n = 2
    imgs = rng.integers(0, 256, (n, SIZE, SIZE, 3), np.uint8)
    mats = _matrices(rng, n)
    alpha = rng.uniform(0.9, 1.1, n).astype(np.float32)
    beta = rng.uniform(-0.1, 0.1, n).astype(np.float32)
    mean = tuple(m * 255.0 for m in IMAGENET_MEAN)
    std = tuple(s * 255.0 for s in IMAGENET_STD)
    want = np.asarray(warp_affine_pallas(
        jnp.asarray(imgs), jnp.asarray(mats), out_dtype=getattr(jnp, out_dtype),
        interpret=True, alpha=jnp.asarray(alpha), beta=jnp.asarray(beta),
        mean=mean, std=std).astype(jnp.float32))
    got = warp_affine_fast(torch.from_numpy(imgs), torch.from_numpy(mats),
                           out_dtype=getattr(torch, out_dtype),
                           alpha=torch.from_numpy(alpha),
                           beta=torch.from_numpy(beta), mean=mean, std=std)
    assert got.dtype == getattr(torch, out_dtype)
    got = got.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want) + 1e-4).all()


def test_plain_warp_identity_and_flip_are_exact():
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, SIZE, SIZE, 3), np.uint8)
    mats = torch.stack([TI.identity_affine(), TI.hflip_matrix(SIZE)])
    got = warp_affine_fast(torch.from_numpy(imgs), mats).numpy()
    np.testing.assert_allclose(got[0], imgs[0], atol=1e-3)
    np.testing.assert_allclose(got[1], imgs[1, :, ::-1], atol=1e-3)


@pytest.mark.parametrize("bilinear", [True, False])
def test_exact_warp_matches_jax(bilinear):
    """Same float32 expressions; 1e-3 gray allows FMA contraction on the
    JAX side.  Nearest is exact."""
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (3, 32, 40, 3), np.uint8)
    mats = np.array(JI.shift_scale_rotate_matrix(
        *[jnp.asarray(x, jnp.float32) for x in
          ([-60.0, 30.0, 80.0], [0.6, 1.3, 1.0], [0.2, -0.3, 0.0], [0.0, 0.1, -0.4])],
        32, 40))
    want = np.asarray(JI.warp_affine(jnp.asarray(imgs), jnp.asarray(mats),
                                     bilinear=bilinear))
    got = TI.warp_affine(torch.from_numpy(imgs), torch.from_numpy(mats),
                         bilinear=bilinear).numpy()
    if bilinear:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
