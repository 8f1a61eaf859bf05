"""The model flags of the opt-in lowerings against the JAX package's models
with the same flags, on the CPU: AttentionUNet(s2d_up, fused_gates),
R2AttUnet(t=2, use_scan, s2d_up, fused_gates) and ResNetUnet(up_as_dot),
at full width at 32px, B=2, on weights drawn with numpy into flax's tree
and carried across by interop/from_jax; and each against the port's
default model on the same weights in float64.  The blocks, the stem and
the re-layouts are in tests/test_torch_twins.py; resnet18(stem_s2d) is
there too."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.core.registry import get_model as jget_model
from medseg_tpu.models.resnet_unet import ResNetUnet as JResNetUnet
from medseg_tpu_torch.core.registry import get_model
from medseg_tpu_torch.interop import from_jax as FJ
from tests import torch_zoo_helpers as Z
from tests.test_torch_seg import _random_variables
from tests.test_torch_twins import _assert_same_function
from tests.test_torch_zoo import TOL

torch.set_num_threads(1)

# name -> (JAX factory kwargs = port factory kwargs of the twin, common kwargs)
MODEL_TWINS = {
    "AttentionUNet": (dict(s2d_up=True, fused_gates=True), {}),
    "R2AttUnet": (dict(use_scan=True, s2d_up=True, fused_gates=True), dict(t=2)),
    "ResNetUnet": (dict(up_as_dot=True), {}),
}


@functools.lru_cache(maxsize=None)
def _model_variables(name):
    if name == "ResNetUnet":
        return _random_variables(JResNetUnet(), jnp.zeros((1, 32, 32, 3)))
    return Z.flax_variables(name)


def _port_sd(name, variables):
    if name == "ResNetUnet":
        return FJ.resnet_unet_state_dict(variables)
    return Z.state_dict(name, variables)


@pytest.mark.parametrize("name", sorted(MODEL_TWINS))
def test_model_flags_match_jax_and_the_default(name):
    """Each model with its flags against the JAX model with the same flags
    on the same weights at 32px, B=2, float32: the eval logits within
    test_torch_zoo.py's TOL (ResNetUnet: test_upt.py's 1e-4 of the
    largest); AttentionUNet also in training, the logits and every running
    statistic at TOL's train and stats (R2AttUnet's JAX train-mode
    compile alone would double the file's time).  Then the twin
    against the port's default model on the same weights in float64 at
    B=1: eval and train logits and statistics within 1e-9 (the blocks' tests hold
    the gradients; R2AttUnet holds R2Unet's flags and its gates)."""
    flags, common = MODEL_TWINS[name]
    variables = _model_variables(name)
    sd = _port_sd(name, variables)
    x = Z.images(1)
    jmodel = jget_model(name)["factory"](**common, **flags)
    factory = get_model(name)["factory"]
    twin = factory(device="cpu", **common, **flags)
    twin.load_state_dict(sd, strict=True)
    trains = name == "AttentionUNet"

    @jax.jit
    def jrun(variables, x):
        evl = jmodel.apply(variables, x, train=False)
        if not trains:
            return evl, None
        return evl, jmodel.apply(variables, x, train=True, mutable=["batch_stats"])

    want, train_run = jax.device_get(jrun(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = twin.eval()(torch.from_numpy(x)).numpy()
    tol = TOL.get(name, dict(eval=1e-4))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol["eval"] * np.abs(want).max())
    if trains:
        want, mut = train_run
        with torch.no_grad():
            got = twin.train()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=tol["train"] * np.abs(want).max())
        want_sd = Z.as_port_names(name, variables["params"], mut["batch_stats"])
        for k, v in twin.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.double().numpy(), want_sd[k], rtol=tol["stats"],
                                           atol=1e-3 * tol["stats"], err_msg=k)
    _assert_same_function(factory(dtype=torch.float64, device="cpu", **common),
                          factory(dtype=torch.float64, device="cpu", **common, **flags),
                          sd, [x[:1]], model=True, grads=False)
