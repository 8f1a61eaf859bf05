"""Kernel B3: the fused stem's plain version and `apply_with_stem_kernel`
against the JAX package's `stem_conv_pool_pallas` and
`apply_with_pallas_stem` (Pallas, interpret mode), on the same numpy inputs
and weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.models.resnet import apply_with_pallas_stem
from medseg_tpu.ops.pallas import stem_kernel as J
from medseg_tpu_torch.models.resnet import apply_with_stem_kernel
from medseg_tpu_torch.ops.kernels import stem_kernel as S
from tests.test_torch_resnet import flax_resnet, port_resnet

torch.set_num_threads(1)

# atol/rtol 1e-4, as tests/test_stem_kernel.py: the same float32 function,
# summed in another order by XLA's conv and by PyTorch's.
TOL = dict(atol=1e-4, rtol=1e-4)
# Every Pallas call below runs at batch 2 and 32 or 64 px: interpret mode
# compiles each new shape for ~40 s on the CPU, and these two are compiled
# once per process.
BATCH = 2


def _random_stem(rng):
    """The numpy arrays of tests/test_stem_kernel.py's `_random_stem`."""
    k = (rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = (rng.standard_normal(64) * 0.1).astype(np.float32)
    mean = (rng.standard_normal(64) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    return k, (scale, bias, mean, var)


def _both(x_nhwc, rng):
    """(port plain version, JAX Pallas kernel) on one batch, BN folded on
    each side from the same numpy arrays."""
    k, bn = _random_stem(rng)
    b, h, w, _ = x_nhwc.shape
    planes = np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2).reshape(b, 3 * h, w))
    g, bb = J.fold_bn(*map(jnp.asarray, bn))
    w2, b2 = J.pack_weights_paired(jnp.asarray(k), g, bb)
    want = np.asarray(J.stem_conv_pool_pallas(jnp.asarray(planes), w2, b2,
                                              interpret=True))
    tg, tb = S.fold_bn(*map(torch.from_numpy, bn))
    weight = torch.from_numpy(k).permute(3, 2, 0, 1) * tg[:, None, None, None]
    got = S.stem_conv_pool_reference(torch.from_numpy(planes),
                                     weight.contiguous(), tb)
    return got.numpy(), want


def test_fold_bn_matches_jax_exactly():
    _, bn = _random_stem(np.random.default_rng(0))
    want = J.fold_bn(*map(jnp.asarray, bn))
    got = S.fold_bn(*map(torch.from_numpy, bn))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("size", [32, 64])
def test_plain_version_matches_pallas_kernel(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((BATCH, size, size, 3)).astype(np.float32)
    got, want = _both(x, rng)
    assert got.shape == want.shape == (BATCH, size // 4, size // 4, 64)
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_version_edge_zero_padding():
    """A constant-1 input exposes any padding mismatch at all four borders."""
    got, want = _both(np.ones((BATCH, 32, 32, 3), np.float32), np.random.default_rng(1))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("depth,planar", [(18, False), (50, True)])
def test_apply_with_stem_kernel_matches_jax(depth, planar):
    """ResNet18 on NHWC input and ResNet50 on the planar layout, float32,
    atol/rtol 2e-4 as tests/test_stem_kernel.py; both sides fold the same
    checkpoint's bn1 (random running statistics) into conv1."""
    model, variables = flax_resnet(depth)
    x = np.random.default_rng(depth).standard_normal((BATCH, 64, 64, 3)).astype(np.float32)
    inp = x.transpose(0, 3, 1, 2).reshape(BATCH, 192, 64) if planar else x
    inp = np.ascontiguousarray(inp)
    want = np.asarray(apply_with_pallas_stem(model, variables, jnp.asarray(inp),
                                             planar=planar, interpret=True))
    port = port_resnet(depth, variables)
    with torch.no_grad():
        got = apply_with_stem_kernel(port, torch.from_numpy(inp), planar=planar)
        full = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    # and the port's own full forward, through the unfolded stem
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-4, rtol=2e-4)


def test_apply_with_stem_kernel_refuses_training_mode():
    _, variables = flax_resnet(18)
    model = port_resnet(18, variables).train()
    with pytest.raises(ValueError, match="inference-only"):
        apply_with_stem_kernel(model, torch.zeros(1, 32, 32, 3))


def test_odd_batch_is_accepted():
    """The TPU kernel's even-batch rule was a Mosaic constraint; the port's
    kernel and plain version take any batch."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    planes = torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2).reshape(3, 96, 32)))
    weight = torch.from_numpy((rng.standard_normal((64, 3, 7, 7)) * 0.1).astype(np.float32))
    bias = torch.zeros(64)
    out = S.stem_conv_pool(planes, weight, bias)
    assert out.shape == (3, 8, 8, 64) and (out >= 0).all()
    # the JAX oracle (XLA conv) on the same function
    want = np.asarray(J.stem_conv_pool_reference(
        jnp.asarray(x), jnp.asarray(weight.permute(2, 3, 1, 0).numpy()),
        jnp.ones(64), jnp.zeros(64)))
    np.testing.assert_allclose(out.numpy(), want, **TOL)


def test_wrapper_runs_plain_version_only_for_cpu_tensors():
    planes = torch.randn(2, 96, 32, generator=torch.Generator().manual_seed(0))
    weight, bias = torch.ones(64, 3, 7, 7) * 0.01, torch.zeros(64)
    before = S.stem_conv_pool.launches
    got = S.stem_conv_pool(planes, weight, bias)
    assert torch.equal(got, S.stem_conv_pool_reference(planes, weight, bias))
    assert S.stem_conv_pool.launches == before  # no launch on the CPU
    with pytest.raises(ValueError, match="no stem kernel"):
        S.stem_conv_pool(planes.to("meta"), weight.to("meta"), bias.to("meta"))


@pytest.mark.parametrize("case", ["dtype", "rows", "width", "weight_shape",
                                  "weight_dtype", "bias"])
def test_wrapper_validates_inputs(case):
    planes, weight, bias = torch.zeros(2, 96, 32), torch.zeros(64, 3, 7, 7), torch.zeros(64)
    if case == "dtype":
        planes = planes.half()
    elif case == "rows":
        planes = torch.zeros(2, 95, 32)
    elif case == "width":
        planes = torch.zeros(2, 96, 30)
    elif case == "weight_shape":
        weight = torch.zeros(64, 3, 3, 3)
    elif case == "weight_dtype":
        weight = weight.bfloat16()
    else:
        bias = torch.zeros(32)
    with pytest.raises(ValueError):
        S._check(planes, weight, bias)

