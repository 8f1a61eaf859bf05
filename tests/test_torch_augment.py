"""augment_batch parity: one augmentation draw, injected into both packages'
`sample_augment_params`, gives the same images and masks; the port's own
draws respect AugmentConfig's limits and rates."""

import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.core.config import AugmentConfig as JConfig
from medseg_tpu.ops import augment as JA
from medseg_tpu.ops.pallas import warp_kernel as jwarp_kernel
from medseg_tpu_torch.core.config import AugmentConfig
from medseg_tpu_torch.ops import augment as TA
from medseg_tpu_torch.ops.warp_fast import fast_warp_supports

torch.set_num_threads(1)

SIZE = 32
# The two-pass warp differs by up to 0.01 gray between XLA (which may
# contract multiply-adds on the CPU) and the port's plain version; after
# brightness/contrast (alpha <= 1.1) and division by the smallest ImageNet
# std (0.224 * 255 = 57 gray) that is 2e-4.
NORM_ATOL = 2e-4


def draw(seed, b):
    """One augmentation draw as numpy arrays, inside the default limits and
    with every gate both on and off across the batch."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    on = np.arange(b) % 2 == 0
    return dict(angle_deg=f32(np.where(on, rng.uniform(-15, 15, b), 0.0)),
                scale=f32(np.where(on, rng.uniform(0.95, 1.05, b), 1.0)),
                dx=f32(np.where(on, rng.uniform(-0.05, 0.05, b), 0.0)),
                dy=f32(np.where(on, rng.uniform(-0.05, 0.05, b), 0.0)),
                flip=np.arange(b) % 3 != 1,
                alpha=f32(rng.uniform(0.9, 1.1, b)),
                beta=f32(rng.uniform(-0.1, 0.1, b)))


def inject(monkeypatch, draws):
    """Make both packages' sample_augment_params return `draws` in turn."""
    jax_draws, port_draws = iter(draws), iter(draws)
    monkeypatch.setattr(JA, "sample_augment_params", lambda rng, b, cfg: JA.AugmentParams(
        **{k: jnp.asarray(v) for k, v in next(jax_draws).items()}))
    monkeypatch.setattr(TA, "sample_augment_params", lambda gen, b, cfg: TA.AugmentParams(
        **{k: torch.from_numpy(v.copy()) for k, v in next(port_draws).items()}))


def _batch(seed, b=3, masks=True):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, SIZE, SIZE, 3), np.uint8)
    m = None
    if masks:  # blobs, so the warp moves region edges
        yy, xx = np.mgrid[:SIZE, :SIZE]
        c = rng.uniform(8, SIZE - 8, (b, 2))
        m = (((yy - c[:, :1, None]) ** 2 + (xx - c[:, 1:, None]) ** 2)
             < 64).astype(np.uint8) * 255
    return images, m


def _run_both(images, masks, jcfg=JConfig(), tcfg=AugmentConfig(),
              dtype="float32", **kw):
    """Both packages' augment_batch on the same batch; outputs as float32
    numpy, after checking that each is in `dtype`."""
    jx, jm = JA.augment_batch(None, jnp.asarray(images),
                              None if masks is None else jnp.asarray(masks),
                              cfg=jcfg, out_dtype=getattr(jnp, dtype), **kw)
    tx, tm = TA.augment_batch(torch.Generator(), torch.from_numpy(images),
                              None if masks is None else torch.from_numpy(masks),
                              cfg=tcfg, out_dtype=getattr(torch, dtype), **kw)
    assert jx.dtype == getattr(jnp, dtype) and tx.dtype == getattr(torch, dtype)
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)  # noqa: E731
    return f32(jx), f32(jm), tx.float().numpy(), f32(None if tm is None else tm.float())


@pytest.mark.parametrize("fast_warp", [True, False])
def test_augment_batch_matches_jax_cpu_branch(monkeypatch, fast_warp):
    """Images within NORM_ATOL (1e-3 gray for the exact warp is far inside
    it); masks are sampled nearest on this branch and must be equal."""
    images, masks = _batch(0)
    inject(monkeypatch, [draw(1, 3)])
    jx, jm, tx, tm = _run_both(images, masks, fast_warp=fast_warp)
    assert tx.shape == jx.shape == (3, SIZE, SIZE, 3)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=NORM_ATOL)
    assert tm.shape == jm.shape == (3, SIZE, SIZE, 1)
    np.testing.assert_array_equal(tm, jm)
    assert set(np.unique(tm)) <= {0.0, 1.0}


def test_augment_batch_bfloat16_matches_jax(monkeypatch):
    """bfloat16 output: one bf16 ulp (at |x| < 4, 2^-6) plus NORM_ATOL, since
    the float32 delta may cross a rounding boundary."""
    images, _ = _batch(2, masks=False)
    inject(monkeypatch, [draw(3, 3)])
    jx, jm, tx, tm = _run_both(images, None, dtype="bfloat16")
    assert jm is None and tm is None
    np.testing.assert_allclose(tx, jx, rtol=0, atol=2.0 ** -6 + NORM_ATOL)


def test_fused_branch_matches_jax_fused_branch(monkeypatch):
    """The branch the card takes (one warp call with the epilogue, the mask
    as a 4th plane thresholded at 127.5*alpha + 255*beta), forced onto CPU
    tensors, against the JAX package's Pallas branch run in interpret mode.
    Images within NORM_ATOL; a mask pixel may flip only where the float32
    delta moves the warped mask value across the threshold, which these
    blobs never do."""
    images, masks = _batch(4)
    inject(monkeypatch, [draw(5, 3)])
    monkeypatch.setattr(JA, "jax", types.SimpleNamespace(
        devices=lambda: [types.SimpleNamespace(platform="tpu")]))
    monkeypatch.setattr(jwarp_kernel, "warp_affine_pallas", functools.partial(
        jwarp_kernel.warp_affine_pallas, interpret=True))
    monkeypatch.setattr(TA, "_on_card", lambda images: True)
    jx, jm, tx, tm = _run_both(images, masks)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=NORM_ATOL)
    np.testing.assert_array_equal(tm, jm)
    assert 0 < tm.mean() < 1


def test_widened_config_takes_the_exact_warp(monkeypatch):
    """A config outside the two-pass warp's envelope never reaches the warp
    kernel, and matches the JAX package's exact-warp fallback."""
    wide = dict(rotate_limit_deg=60.0, scale_limit=0.3)
    tcfg = dataclasses.replace(AugmentConfig(), **wide)
    jcfg = dataclasses.replace(JConfig(), **wide)
    assert not fast_warp_supports(tcfg, SIZE, SIZE)

    def no_kernel(*a, **k):
        raise AssertionError("the warp kernel ran outside its envelope")

    monkeypatch.setattr(TA, "warp_affine_kernel", no_kernel)
    monkeypatch.setattr(TA, "_on_card", lambda images: True)
    images, masks = _batch(6)
    d = draw(7, 3)
    d["angle_deg"] = np.array([50.0, -40.0, 0.0], np.float32)
    inject(monkeypatch, [d])
    jx, jm, tx, tm = _run_both(images, masks, jcfg=jcfg, tcfg=tcfg)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=NORM_ATOL)
    np.testing.assert_array_equal(tm, jm)


def test_sampled_params_respect_config():
    """Every draw lies in its limit range, and each Bernoulli gate fires at
    its rate: 5 binomial standard deviations at n=4096 is at most 0.04."""
    cfg = AugmentConfig()
    n = 4096
    p = TA.sample_augment_params(torch.Generator().manual_seed(0), n, cfg)
    assert all(v.shape == (n,) for v in p)
    assert p.flip.dtype == torch.bool

    affine = (p.angle_deg != 0) | (p.scale != 1) | (p.dx != 0) | (p.dy != 0)
    assert abs(affine.float().mean().item() - cfg.affine_p) < 0.04
    assert p.angle_deg.abs().max() <= cfg.rotate_limit_deg
    assert (p.scale - 1).abs().max() <= cfg.scale_limit + 1e-6
    assert max(p.dx.abs().max(), p.dy.abs().max()) <= cfg.shift_limit
    # gated-off samples keep the identity transform exactly
    assert (p.scale[~affine] == 1).all() and (p.dx[~affine] == 0).all()
    assert abs(p.flip.float().mean().item() - cfg.hflip_p) < 0.04

    bc = (p.alpha != 1) | (p.beta != 0)
    assert abs(bc.float().mean().item() - cfg.brightness_contrast_p) < 0.04
    assert (p.alpha - 1).abs().max() <= cfg.contrast_limit + 1e-6
    assert p.beta.abs().max() <= cfg.brightness_limit
    # within the gate, draws spread over their range (uniform: mean ~0)
    assert abs(p.angle_deg[affine].mean().item()) < 0.05 * cfg.rotate_limit_deg
    assert p.angle_deg[affine].abs().max() > 0.95 * cfg.rotate_limit_deg


def test_sampling_is_reproducible_from_the_generator_seed():
    cfg = AugmentConfig()
    a = TA.sample_augment_params(torch.Generator().manual_seed(3), 8, cfg)
    b = TA.sample_augment_params(torch.Generator().manual_seed(3), 8, cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_preprocess_eval_batch_matches_jax():
    images, masks = _batch(8)
    jx, jm = JA.preprocess_eval_batch(jnp.asarray(images), jnp.asarray(masks))
    tx, tm = TA.preprocess_eval_batch(torch.from_numpy(images), torch.from_numpy(masks))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
