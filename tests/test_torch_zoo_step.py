"""One train step of each model of the rest of the CNN zoo against the JAX
package's, on the CPU at full width, 32px, B=2: seg_train_step (BCE) for
AttentionUNet, R2U-Net and R2AttU-Net, cls_train_step (label-smoothed CE,
dropouts off in both) for VGG16/19, every parameter trainable, global-norm
clip 1.0 and AdamW at lr 1e-3.  The tolerances and their derivation are
tests/test_torch_zoo.py's TOL."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.train import losses as JL
from medseg_tpu.train import steps as JS
from medseg_tpu.train.freeze import all_trainable as jall_trainable
from medseg_tpu_torch.train import steps as TS
from medseg_tpu_torch.train.freeze import all_trainable, set_trainable
from tests import torch_zoo_helpers as Z
from tests.test_torch_zoo import TOL

torch.set_num_threads(1)

LR, WD, CLIP = 1e-3, 5e-4, 1.0


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    """One JAX train step (cls_train_body or seg_train_body, prep None) from
    the test variables on the test batch: (the state after it, its loss,
    the step's clipped gradients under the port's names, their norm)."""
    model, variables = Z.flax_model(name), Z.flax_variables(name)
    x, y = jnp.asarray(Z.images(1)), jnp.asarray(Z.targets(name, 1))
    params = variables["params"]
    opt = JS.build_optimizer(LR, WD, CLIP, jall_trainable(params))
    state = JS.init_state(model, jax.tree.map(jnp.asarray, variables), opt)
    cls = name in Z.CLS

    def loss_fn(p):
        out, _ = model.apply({"params": p, "batch_stats": state.batch_stats}, x,
                             train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.key(0)})
        return JL.cross_entropy(out, y, 0.1) if cls else JL.bce_with_logits(out, y)

    body = JS.cls_train_body(model, opt, 0.1) if cls else JS.seg_train_body(model, opt)
    with Z.flax_dropout_off():
        grads = jax.device_get(jax.jit(jax.grad(loss_fn))(state.params))
        new_state, loss = jax.jit(body)(state, x, y, jax.random.key(0))[:2]
    norm = float(np.sqrt(sum(float(np.sum(np.square(g))) for g in jax.tree.leaves(grads))))
    scale = min(1.0, CLIP / norm)
    clipped = Z.as_port_names(name, jax.tree.map(lambda g: np.asarray(g) * scale, grads),
                              variables["batch_stats"])
    return jax.device_get(new_state), float(loss), clipped, norm


def _port_step(name, dtype):
    model = Z.port_model(name, Z.flax_variables(name), dtype).train()
    opt = TS.build_optimizer(LR, WD, CLIP, set_trainable(model, all_trainable))
    x = torch.from_numpy(Z.images(1)).to(dtype)
    y = torch.from_numpy(Z.targets(name, 1))
    gen = torch.Generator().manual_seed(0)
    if name in Z.CLS:
        loss = TS.cls_train_step(model, opt, x, y, gen, 0.1)[0]
    else:
        loss = TS.seg_train_step(model, opt, x, y.to(dtype), gen)
    return model, loss.item()


@pytest.mark.parametrize("name", Z.SEG + Z.CLS)
def test_train_step_matches_jax(name):
    """The port's step in float64 and in float32 against JAX's float32 step
    on the same weights and batch:
    - the loss: 6e-5 relative in both.  The losses' float32 distances from
      the port's float64 step are 1.8e-5 (VGG19's, the port's; JAX's
      5.2e-6) at most: three times that;
    - the float64 step's clipped gradients within TOL["grads"] of the
      largest |g| (the float32 ones may take a ReLU kink the other way, see
      TOL);
    - the parameters after either step: none off by more than 2*lr, and
      within 1e-6 + 2% of lr wherever |g| exceeds ten times the gradients'
      tolerance.  AdamW's first step moves each element by about
      lr*sign(g) whatever its gradient's size, so where |g| is within
      float32 noise of zero either framework moves it by +-lr;
    - every running statistic within TOL["stats"] relative."""
    state, loss, clipped, norm = _jax_step(name)
    assert norm > CLIP  # the clip fires
    tol = TOL[name]
    final = Z.as_port_names(name, state.params, state.batch_stats)
    gmax = max(np.abs(g).max() for g in clipped.values())
    sure = {n: np.abs(g) > 10 * tol["grads"] * gmax for n, g in clipped.items()}
    assert sum(int(s.sum()) for s in sure.values()) >= 20
    for dtype in (torch.float64, torch.float32):
        model, got = _port_step(name, dtype)
        np.testing.assert_allclose(got, loss, rtol=6e-5, err_msg=str(dtype))
        for pname, p in model.named_parameters():
            if dtype == torch.float64:
                np.testing.assert_allclose(p.grad.numpy(), clipped[pname], rtol=0,
                                           atol=tol["grads"] * gmax, err_msg=pname)
            diff = np.abs(p.detach().double().numpy() - final[pname])
            assert diff.max() <= 2 * LR, (pname, dtype, diff.max())
            assert (diff[sure[pname]] <= 1e-6 + 0.02 * LR).all(), (pname, dtype)
        for bname, buf in model.named_buffers():
            if bname.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buf.double().numpy(), final[bname],
                                           rtol=tol["stats"], atol=1e-3 * tol["stats"],
                                           err_msg=f"{bname} {dtype}")
