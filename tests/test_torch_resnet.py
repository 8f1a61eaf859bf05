"""ResNet parity: the JAX package's flax ResNetClassifier and the port's, with
weights carried across by interop/from_jax, on the same numpy inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.interop.export_torch import export_resnet_classifier
from medseg_tpu.models import resnet as jresnet
from medseg_tpu_torch.interop.from_jax import resnet_classifier_state_dict
from medseg_tpu_torch.models import resnet as tresnet

torch.set_num_threads(1)

SIZE = 32


def _random_leaf(rng, path, shape):
    """He-scaled conv/dense kernels; BN scale, bias and running statistics
    away from their init values, so a BN conversion slip shows."""
    name = path[-1].key
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(0, np.sqrt(2.0 / fan_in), shape)
    if name in ("scale", "var"):
        return rng.uniform(0.5, 1.5, shape)
    return rng.normal(0, 0.1, shape)  # bias, mean


@functools.lru_cache(maxsize=None)
def flax_resnet(depth: int, seed: int = 0):
    """(flax model, numpy variables drawn from `seed`) for ResNet18/50.
    The variable tree comes from flax's own init, traced for shapes only."""
    model = {18: jresnet.resnet18, 50: jresnet.resnet50}[depth]()
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: _random_leaf(rng, p, s.shape).astype(np.float32), shapes)
    return model, variables


def port_resnet(depth: int, variables, dtype=torch.float32):
    """The port's classifier on the CPU, holding the flax weights."""
    factory = {18: tresnet.resnet18, 50: tresnet.resnet50}[depth]
    model = factory(dtype=dtype, device="cpu")
    model.load_state_dict(resnet_classifier_state_dict(variables, depth), strict=True)
    return model.eval()


def _images(seed, b=2):
    """Inputs on the scale of normalized images."""
    return np.random.default_rng(seed).normal(0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("depth", [18, 50])
def test_state_dict_equals_export_torch_bitwise(depth):
    _, variables = flax_resnet(depth)
    want = export_resnet_classifier(variables, depth)
    got = resnet_classifier_state_dict(variables, depth)
    assert list(got) == list(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    # it loads with strict=True, and every module name is torchvision's
    model = port_resnet(depth, variables)
    assert set(model.state_dict()) == set(want)


@pytest.mark.parametrize("depth", [18, 50])
def test_eval_forward_matches_flax_float32(depth):
    """rtol/atol 1e-4: the same float32 network; the CPU convolutions of XLA
    and of PyTorch sum in different orders."""
    model, variables = flax_resnet(depth)
    x = _images(depth)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port_resnet(depth, variables)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_eval_forward_matches_flax_bfloat16():
    """bfloat16 keeps 8 significant bits and the two frameworks round at
    other places (flax casts each layer's inputs; the port's BatchNorm
    normalizes in float32), so each logit may differ by 2% of the largest
    float32 logit magnitude.  Argmax must agree wherever the float32 margin
    between the top two logits exceeds twice that tolerance."""
    _, variables = flax_resnet(18)
    jmodel = jresnet.resnet18(dtype=jnp.bfloat16)
    x = _images(7, b=4)
    f32 = np.asarray(jresnet.resnet18().apply(variables, jnp.asarray(x), train=False))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port_resnet(18, variables, torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32  # the head is float32
    tol = 0.02 * np.abs(f32).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    top2 = np.sort(f32, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(got.numpy().argmax(-1)[clear], want.argmax(-1)[clear])
