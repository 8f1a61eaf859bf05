"""The port's train layer against the JAX package's: schedules, losses, the
stage-1 mask, train-mode ResNet18 (BatchNorm's running statistics), the
optimizer step by step, the eval step and the flax-like init, on the same
numpy inputs and weights carried across by interop/from_jax."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medseg_tpu.core import config as jconfig
from medseg_tpu.core.precision import policy_from_name as jpolicy_from_name
from medseg_tpu.models import resnet as jresnet
from medseg_tpu.train import losses as JL
from medseg_tpu.train import schedules as JSched
from medseg_tpu.train import steps as JS
from medseg_tpu.train.freeze import (all_trainable as jall_trainable,
                                     head_only as jhead_only,
                                     mask_from_predicate)
from medseg_tpu_torch.core import config as tconfig
from medseg_tpu_torch.core.precision import policy_from_name
from medseg_tpu_torch.interop.from_jax import resnet_classifier_state_dict
from medseg_tpu_torch.models import resnet as tresnet
from medseg_tpu_torch.nn.blocks import ClassifierHead
from medseg_tpu_torch.train import losses as TL
from medseg_tpu_torch.train import schedules as TSched
from medseg_tpu_torch.train import steps as TS
from medseg_tpu_torch.train.freeze import all_trainable, head_only, set_trainable
from tests.test_torch_resnet import SIZE, flax_resnet

torch.set_num_threads(1)

B = 4
WD = 5e-4


def _images(seed, b=B):
    return np.random.default_rng(seed).normal(0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)


def _labels(seed, b=B):
    return np.random.default_rng(seed).integers(0, 3, b).astype(np.int32)


def port_model(variables, dtype=torch.float32):
    """The port's ResNet18 on the CPU with dropout 0, holding `variables`."""
    model = tresnet.resnet18(dtype=dtype, device="cpu", dropout=0.0)
    model.load_state_dict(resnet_classifier_state_dict(variables, 18), strict=True)
    return model


def _as_port_names(params, batch_stats):
    """A flax (params, batch_stats) pair as numpy arrays under the port's
    names and layouts (from_jax's mapping)."""
    sd = resnet_classifier_state_dict({"params": params, "batch_stats": batch_stats}, 18)
    return {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}


# --- configs, schedules, losses ----------------------------------------------

def test_train_config_and_policy_match_jax():
    assert (dataclasses.asdict(tconfig.TrainConfig())
            == dataclasses.asdict(jconfig.TrainConfig()))
    cfg = tconfig.TrainConfig(save_root="w")
    assert cfg.cls_save_dir == jconfig.TrainConfig(save_root="w").cls_save_dir
    assert cfg.seg_save_dir == jconfig.TrainConfig(save_root="w").seg_save_dir
    for name in ("bfloat16", "bf16", "mixed", "float32", "fp32", "full"):
        want = jpolicy_from_name(name).compute_dtype
        assert str(policy_from_name(name).compute_dtype) == f"torch.{jnp.dtype(want).name}"
    with pytest.raises(ValueError, match="Unknown precision policy"):
        policy_from_name("fp16")


def test_cosine_annealing_matches_jax():
    for lr0, t_max in ((1e-4, 5), (1e-3, 1), (3e-2, 7)):
        for epoch in range(t_max + 1):
            assert (TSched.cosine_annealing(lr0, epoch, t_max)
                    == JSched.cosine_annealing(lr0, epoch, t_max))


def test_plateau_and_early_stopping_match_jax():
    scores = [10.0, 20.0, 20.0, 19.0, 20.001, 18.0, 30.0, 30.0, 30.0, 30.0, 30.0,
              29.0, 25.0, 40.0, 40.0, 40.0, 40.0, 40.0]
    tp, jp = TSched.ReduceLROnPlateau(1e-3, "max", 0.1, 3), JSched.ReduceLROnPlateau(
        1e-3, "max", 0.1, 3)
    te, je = TSched.EarlyStopping(4, "max"), JSched.EarlyStopping(4, "max")
    lrs = []
    for s in scores:
        lrs.append(tp.step(s))
        assert lrs[-1] == jp.step(s)
        assert te.update(s) == je.update(s)
        assert te.should_stop == je.should_stop
    assert lrs[-1] < lrs[0]  # the sequence reaches a reduction


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    """1e-6: float32 log-softmax of the same logits."""
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (7, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 7).astype(np.int32)
    want = np.asarray(JL.per_sample_cross_entropy(jnp.asarray(logits),
                                                  jnp.asarray(labels), smoothing))
    t_logits, t_labels = torch.from_numpy(logits), torch.from_numpy(labels)
    got = TL.per_sample_cross_entropy(t_logits, t_labels, smoothing)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        TL.cross_entropy(t_logits, t_labels, smoothing).item(),
        float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing)),
        rtol=1e-6, atol=1e-6)
    # torch's own label-smoothed CE is the same function
    np.testing.assert_allclose(
        got.numpy(), torch.nn.functional.cross_entropy(
            t_logits, t_labels.long(), reduction="none",
            label_smoothing=smoothing).numpy(), rtol=1e-6, atol=1e-6)
    for n_valid in (0, 4, 7):
        np.testing.assert_array_equal(TL.valid_mask(7, n_valid).numpy(),
                                      np.asarray(JL.valid_mask(7, n_valid)))


# --- freezing -----------------------------------------------------------------

@pytest.mark.parametrize("stage", [1, 2])
def test_trainable_set_matches_jax_mask(stage):
    """The JAX mask, carried through from_jax's key names, selects exactly
    the parameters the port trains."""
    _, variables = flax_resnet(18)
    params = variables["params"]
    mask = mask_from_predicate(params, jhead_only("ResNet18")) if stage == 1 \
        else jall_trainable(params)
    as_arrays = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                             mask, params)
    sd = resnet_classifier_state_dict(
        {"params": as_arrays, "batch_stats": variables["batch_stats"]}, 18)
    model = port_model(variables)
    want = {name for name, _ in model.named_parameters() if sd[name].all()}
    assert all(not sd[name].any() for name, _ in model.named_parameters()
               if name not in want)
    pred = head_only("ResNet18") if stage == 1 else all_trainable
    trainable = set_trainable(model, pred)
    got = {name for name, p in model.named_parameters() if p.requires_grad}
    assert got == want and len(trainable) == len(want)
    assert (got == {"fc.1.weight", "fc.1.bias"}) == (stage == 1)
    with pytest.raises(ValueError, match="no stage-1 head rule"):
        head_only("CLIP")


# --- train-mode forward -------------------------------------------------------

def test_train_mode_forward_matches_flax():
    """ResNet18 at 32px, B=4, dropout 0, float32: the logits (1e-4, the CPU
    convolutions' summation order) and the updated running statistics
    (1e-5: flax's biased-variance blend; torch's unbiased blend would be
    off by the 4/3 factor of the last stage's n=4 values a channel)."""
    _, variables = flax_resnet(18)
    x = _images(11)
    jmodel = jresnet.resnet18(dropout=0.0)
    want, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    model = port_model(variables).train()
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    want_sd = _as_port_names(variables["params"], mutated["batch_stats"])
    old_sd = _as_port_names(variables["params"], variables["batch_stats"])
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_sd[name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    # the unbiased blend is measurably different at this size
    bn = model.layer4[1].bn2
    old_var = torch.from_numpy(old_sd["layer4.1.bn2.running_var"])
    biased = (bn.running_var - 0.9 * old_var) / 0.1
    unbiased_blend = 0.9 * old_var + 0.1 * biased * 4 / 3
    assert (unbiased_blend - bn.running_var).abs().max() > 1e-2


def test_bf16_train_mode_statistics_are_float32():
    """bf16 activations, float32 statistics: the running statistics stay
    float32 and within bf16's rounding of the float32 model's."""
    _, variables = flax_resnet(18)
    x = torch.from_numpy(_images(12))
    f32 = port_model(variables).train()
    bf16 = port_model(variables, torch.bfloat16).train()
    f32(x)
    out = bf16(x)
    assert out.dtype == torch.float32
    for (name, a), (_, b) in zip(f32.named_buffers(), bf16.named_buffers()):
        if name.endswith("running_mean"):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0.05, atol=0.02,
                                       err_msg=name)


def test_dropout_draws_from_the_generator():
    """flax's mask semantics: keep with probability 1-p, scale by 1/(1-p);
    the same generator state gives the same mask; no generator, no dropout
    in training."""
    head = ClassifierHead(64, 3, dropout=0.5).train()
    x = torch.ones(512, 64)
    from medseg_tpu_torch.nn.blocks import dropout
    y = dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs((y > 0).float().mean().item() - 0.5) < 0.02
    a = head(x, torch.Generator().manual_seed(1))
    b = head(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        head(x)
    assert torch.equal(head.eval()(x), head[1](x))  # eval: no dropout


# --- the optimizer, step by step ----------------------------------------------

def _jax_loss_fn(model, batch_stats, x, y):
    def loss_fn(params):
        out, _ = model.apply({"params": params, "batch_stats": batch_stats}, x,
                             train=True, mutable=["batch_stats"])
        return JL.cross_entropy(out, y, 0.1)
    return loss_fn


@functools.lru_cache(maxsize=None)
def _jax_grad():
    model = jresnet.resnet18(dropout=0.0)
    return jax.jit(lambda params, stats, x, y: jax.grad(
        _jax_loss_fn(model, stats, x, y))(params))


def _clip_numpy(grads, mask, max_norm):
    """optax's clip_by_global_norm over the trainable leaves; frozen leaves
    zero (the JAX optimizer's set_to_zero)."""
    leaves = [g for g, m in zip(jax.tree.leaves(grads), jax.tree.leaves(mask)) if m]
    norm = float(np.sqrt(sum(float(np.sum(np.square(g))) for g in leaves)))
    scale = 1.0 if norm < max_norm else max_norm / norm
    return jax.tree.map(lambda g, m: np.asarray(g) * scale if m else np.zeros_like(g),
                        grads, mask), norm


# stage, learning rate, clip norm, whether the clip fires at step 1 (asserted
# on the JAX side).  Stage 2 moves every weight of the network by about lr
# a step: at 1e-3 three steps change the loss by half, and the frameworks'
# float32 differences grow with it; the reference's stage-2 lr is 1e-6.
STEP_CASES = [(1, 1e-3, 100.0, False), (2, 1e-5, 1.0, True)]


@functools.lru_cache(maxsize=None)
def _jax_run(stage, lr, clip):
    """Three JAX train steps (make_cls_train_step, prep=None) from the test
    ResNet18's variables; the state before each step and its loss."""
    _, variables = flax_resnet(18)
    model = jresnet.resnet18(dropout=0.0)
    params = variables["params"]
    mask = (mask_from_predicate(params, jhead_only("ResNet18")) if stage == 1
            else jall_trainable(params))
    opt = JS.build_optimizer(lr, WD, clip, mask)
    step = JS.make_cls_train_step(model, opt, 0.1, prep=None)
    state = JS.init_state(model, jax.tree.map(jnp.asarray, variables), opt)
    states, step_losses = [], []
    for i in range(3):
        states.append(jax.device_get(state))
        state, loss, _ = step(state, jnp.asarray(_images(20 + i)),
                              jnp.asarray(_labels(20 + i)), jax.random.key(0))
        step_losses.append(float(loss))
    return states + [jax.device_get(state)], step_losses, mask


@pytest.mark.parametrize("stage,lr,clip,fires", STEP_CASES)
def test_optimizer_steps_match_jax(stage, lr, clip, fires):
    """Three steps of each stage's optimizer (weight decay 5e-4) against
    make_cls_train_step on the same batches:
    - each step's loss: 1e-4 relative (the float32 forwards differ by 6e-6
      at step 1; the parameters then differ as below);
    - each step's clipped gradients: 2e-4 of the largest |g| (float32
      backward through 20 layers; 6e-5 seen), frozen parameters without a
      gradient;
    - the parameters after step 3: all but 1 in 10^4 elements within
      1e-6 + 2% of 3*lr, and none off by more than 2*3*lr.  AdamW's first
      steps move each element by about lr whatever its gradient's size, so
      an element whose gradient is within float32 noise of zero moves by
      +-lr in either framework (stage 2: 64 of 11.2M elements, 2.1*lr at
      most);
    - the running statistics after step 3: 1e-4 (also in stage 1, where the
      frozen trunk's BatchNorm still trains)."""
    states, step_losses, mask = _jax_run(stage, lr, clip)
    _, variables = flax_resnet(18)
    model = port_model(variables).train()
    pred = head_only("ResNet18") if stage == 1 else all_trainable
    opt = TS.build_optimizer(lr, WD, clip, set_trainable(model, pred))
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        x, y = torch.from_numpy(_images(20 + i)), torch.from_numpy(_labels(20 + i))
        loss, correct = TS.cls_train_step(model, opt, x, y, gen, 0.1)
        np.testing.assert_allclose(loss.item(), step_losses[i], rtol=1e-4)
        assert 0 <= correct.item() <= B
        jgrads = _jax_grad()(states[i].params, states[i].batch_stats,
                             jnp.asarray(_images(20 + i)), jnp.asarray(_labels(20 + i)))
        clipped, norm = _clip_numpy(jax.device_get(jgrads), mask, clip)
        if i == 0:
            assert (norm >= clip) == fires, norm
        want = _as_port_names(clipped, states[i].batch_stats)
        gmax = max(np.abs(v).max() for v in want.values())
        for name, p in model.named_parameters():
            if p.requires_grad:
                np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                           atol=2e-4 * gmax, err_msg=name)
            else:
                assert p.grad is None and not want[name].any(), name
    final = _as_port_names(states[3].params, states[3].batch_stats)
    n_off = n_all = 0
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - final[name])
        assert diff.max() <= 2 * 3 * lr, (name, diff.max())
        n_off += int((diff > 1e-6 + 0.02 * 3 * lr).sum())
        n_all += diff.size
    assert n_off <= 1e-4 * n_all, (n_off, n_all)
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), final[name], rtol=1e-4,
                                       atol=1e-4, err_msg=name)


def test_clip_matches_optax():
    """clip_by_global_norm_ against optax's on the same arrays, firing and
    not: 1e-6."""
    rng = np.random.default_rng(5)
    arrays = [rng.normal(0, 1, s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for max_norm in (1.0, 100.0):
        tx = optax.clip_by_global_norm(max_norm)
        want, _ = tx.update([jnp.asarray(a) for a in arrays], tx.init(arrays))
        grads = [torch.from_numpy(a.copy()) for a in arrays]
        norm = TS.clip_by_global_norm_(grads, max_norm)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(arrays)),
                                   rtol=1e-6)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_learning_rate_round_trip():
    opt = TS.build_optimizer(1e-3, WD, 1.0, [torch.nn.Parameter(torch.zeros(3))])
    TS.set_learning_rate(opt, 2.5e-5)
    assert TS.get_learning_rate(opt) == 2.5e-5
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.999), 1e-8, WD)


def test_eval_step_matches_jax_on_a_padded_batch():
    """Rows past n_valid (the loader's repeats of the last sample) add
    nothing: loss_sum 1e-5 relative, correct and preds equal."""
    model, variables = flax_resnet(18)
    x = _images(30, b=6)
    x[4:] = x[3]  # pad rows repeat the last real sample
    y = _labels(30, b=6)
    y[4:] = y[3]
    step = JS.make_cls_eval_step(model, 0.1)
    port = port_model(variables).eval()
    for n_valid in (4, 6):
        loss_sum, correct, preds = step(variables["params"], variables["batch_stats"],
                                        jnp.asarray(x), jnp.asarray(y), n_valid)
        t_loss, t_correct, t_preds = TS.cls_eval_step(
            port, torch.from_numpy(x), torch.from_numpy(y), n_valid, 0.1)
        np.testing.assert_allclose(t_loss.item(), float(loss_sum), rtol=1e-5)
        assert t_correct.item() == int(correct)
        np.testing.assert_array_equal(t_preds.numpy(), np.asarray(preds))


# --- init ---------------------------------------------------------------------

def test_init_matches_flax_lecun_normal():
    """Per layer, the std of the port's conv and Linear weights from
    init_weights matches flax's init of the same layer within 5% (the
    streams differ, so the distributions are compared), every value within
    the truncation at 2 std; biases 0, BatchNorm 1/0/0/1."""
    jvars = jresnet.resnet18().init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
    want = _as_port_names(jvars["params"], jvars["batch_stats"])
    model = tresnet.resnet18(device="cpu")
    tresnet.init_weights(model, torch.Generator().manual_seed(0))
    n_checked = 0
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        if name.endswith("weight") and p.dim() in (2, 4):
            fan_in = got[0].size
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert abs(got.std() / want[name].std() - 1) < 0.05, name
            assert abs(got.std() / (std * 0.87962566103423978) - 1) < 0.05, name
            assert np.abs(got).max() <= 2 * std * (1 + 1e-6), name
            n_checked += 1
        else:
            np.testing.assert_array_equal(got, want[name], err_msg=name)
    assert n_checked == 21  # 20 convs and the Linear
    for name, buf in model.named_buffers():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(buf.numpy(), want[name], err_msg=name)
