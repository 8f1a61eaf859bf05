"""Kernel B2: the photometric kernel's plain version against the JAX
package's `fused_photometric` (Pallas, interpret mode) on the same numpy
inputs, the eval preprocessing it serves on the card, and its wrapper."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.ops import augment as JA
from medseg_tpu.ops.pallas.photometric import fused_photometric as jax_photometric
from medseg_tpu_torch.ops import augment as TA
from medseg_tpu_torch.ops.kernels import photometric as P

torch.set_num_threads(1)


def _inputs(seed, b=3, h=16, w=16):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, h, w, 3), np.uint8)
    alpha = rng.uniform(0.9, 1.1, b).astype(np.float32)
    beta = rng.uniform(-0.1, 0.1, b).astype(np.float32)
    flip = np.arange(b) % 2 == 1
    return images, alpha, beta, flip


def _both(images, alpha, beta, flip, dtype):
    want = np.asarray(jax_photometric(
        jnp.asarray(images), jnp.asarray(alpha), jnp.asarray(beta),
        jnp.asarray(flip), out_dtype=getattr(jnp, dtype),
        interpret=True).astype(jnp.float32))
    got = P.fused_photometric_reference(
        torch.from_numpy(images), torch.from_numpy(alpha), torch.from_numpy(beta),
        torch.from_numpy(flip), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    return got.float().numpy(), want


def test_plain_version_matches_jax_float32():
    """rtol 1e-5, atol 1e-4, as the JAX package's own test: XLA on the CPU
    may reorder the float32 epilogue; the flip is exact."""
    got, want = _both(*_inputs(0), "float32")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_plain_version_matches_jax_bfloat16():
    """atol 0.05, as the JAX package's own bf16 test: one bf16 ulp at |x| < 4
    is 2^-6, so a float32 delta may move a value by one ulp."""
    got, want = _both(*_inputs(1, b=4, h=8, w=12), "bfloat16")
    np.testing.assert_allclose(got, want, atol=0.05)


def test_eval_form_equals_jax_preprocess_eval_batch_exactly():
    """alpha=1, beta=0, no flip: x*1 + 0 is exact and the clip does nothing
    on 0..255, so the kernel's function is the eval normalization bit for
    bit, in the JAX package and in the port."""
    images, *_ = _inputs(2, b=2)
    b = len(images)
    want, _ = JA.preprocess_eval_batch(jnp.asarray(images))
    got = P.fused_photometric_reference(
        torch.from_numpy(images), torch.ones(b), torch.zeros(b),
        torch.zeros(b, dtype=torch.bool))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preprocess_eval_batch_card_branch(monkeypatch, dtype):
    """The branch the card takes (one photometric kernel launch), forced onto
    CPU tensors where the wrapper runs the plain version, equals the CPU
    branch exactly, and JAX's preprocess_eval_batch in float32."""
    images, *_ = _inputs(3, b=2)
    out_dtype = getattr(torch, dtype)
    cpu, _ = TA.preprocess_eval_batch(torch.from_numpy(images), out_dtype=out_dtype)
    calls = []
    monkeypatch.setattr(TA, "_on_card", lambda images: True)
    monkeypatch.setattr(TA, "fused_photometric",
                        lambda *a, **k: calls.append(a) or P.fused_photometric(*a, **k))
    card, _ = TA.preprocess_eval_batch(torch.from_numpy(images), out_dtype=out_dtype)
    assert len(calls) == 1 and card.dtype == out_dtype
    assert calls[0][1:4] == (None, None, None)  # the eval form: no tensors built
    assert torch.equal(card, cpu)
    if dtype == "float32":
        want, _ = JA.preprocess_eval_batch(jnp.asarray(images))
        np.testing.assert_array_equal(card.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_none_form_equals_explicit_form_and_jax_eval_exactly(dtype):
    """alpha, beta and flip None: bit for bit the explicit alpha=1, beta=0,
    no-flip form, and in float32 JAX's preprocess_eval_batch."""
    images, *_ = _inputs(6, b=3, h=8, w=16)
    out_dtype = getattr(torch, dtype)
    x = torch.from_numpy(images)
    got = P.fused_photometric(x, None, None, None, out_dtype)
    assert got.dtype == out_dtype
    explicit = P.fused_photometric(x, torch.ones(3), torch.zeros(3),
                                   torch.zeros(3, dtype=torch.bool), out_dtype)
    assert torch.equal(got, explicit)
    if dtype == "float32":
        want, _ = JA.preprocess_eval_batch(jnp.asarray(images))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_check_accepts_the_none_form_and_refuses_a_partial_one():
    images, alpha, beta, flip = map(torch.from_numpy, _inputs(7, b=2, h=8, w=8))
    kw = dict(out_dtype=torch.float32, mean=(0.5,) * 3, std=(0.25,) * 3)
    P._check(images, None, None, None, **kw)
    for partial in ((alpha, None, None), (None, beta, flip), (alpha, beta, None)):
        with pytest.raises(ValueError, match="all None"):
            P._check(images, *partial, **kw)


def test_wrapper_runs_plain_version_only_for_cpu_tensors():
    images, alpha, beta, flip = map(torch.from_numpy, _inputs(4, b=2, h=8, w=8))
    before = P.fused_photometric.launches
    got = P.fused_photometric(images, alpha, beta, flip)
    assert torch.equal(got, P.fused_photometric_reference(images, alpha, beta, flip))
    assert P.fused_photometric.launches == before  # no launch on the CPU
    with pytest.raises(ValueError, match="no photometric kernel"):
        P.fused_photometric(*(t.to("meta") for t in (images, alpha, beta, flip)))


@pytest.mark.parametrize("case", ["dtype", "channels", "alpha", "flip_dtype",
                                  "out_dtype", "mean"])
def test_wrapper_validates_inputs(case):
    images, alpha, beta, flip = map(torch.from_numpy, _inputs(5, b=2, h=8, w=8))
    kw = dict(out_dtype=torch.float32, mean=(0.5,) * 3, std=(0.25,) * 3)
    if case == "dtype":
        images = images.float()
    elif case == "channels":
        images = torch.zeros(2, 8, 8, 5, dtype=torch.uint8)
    elif case == "alpha":
        alpha = alpha[:1]
    elif case == "flip_dtype":
        flip = flip.float()
    elif case == "out_dtype":
        kw["out_dtype"] = torch.float16
    else:
        kw["mean"] = (0.5,) * 2
    with pytest.raises(ValueError):
        P._check(images, alpha, beta, flip, **kw)
