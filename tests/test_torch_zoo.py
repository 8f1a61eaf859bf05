"""The rest of the CNN zoo against the JAX package, on the CPU: the U-Net
blocks (UpConv, AttentionGate, RecurrentBlock, RRCNNBlock) at narrow
widths, the adaptive pool and the nearest upsample, then AttentionUNet,
R2U-Net, R2AttU-Net and VGG16/19-BN at full width on small grids (32px;
VGG also 64px, where the adaptive pool bins 2x2 to 7x7), B=2: the state
dicts' keys against the reference-style oracles and the JAX exporters,
the eval forward, the train forward with its running statistics, one
train step, VGG's stage-1 rule and its dropouts.  Weights are drawn with
numpy into flax's variable tree and carried across by interop/from_jax.

Tolerances come from float64: the same inputs through the port's float64
model give the reference, and each check allows a small multiple of the
JAX package's own float32 distance from it, stated where it is set."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.nn import blocks as JB
from medseg_tpu.train.freeze import head_only as jhead_only
from medseg_tpu.train.freeze import mask_from_predicate
from medseg_tpu_torch.core.registry import get_model
from medseg_tpu_torch.interop import from_jax as FJ
from medseg_tpu_torch.models.resnet import init_weights
from medseg_tpu_torch.nn import blocks as TB
from medseg_tpu_torch.train.freeze import (all_trainable, finetune_filter, head_only,
                                           set_trainable)
from tests import torch_zoo_helpers as Z
from tests.test_torch_resnet import _random_leaf

torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _block_variables(block, *inputs, seed):
    shapes = jax.eval_shape(lambda: block.init(jax.random.key(0), *inputs))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _random_leaf(rng, p, s.shape).astype(np.float32), shapes)


def _block_state_dict(convert, variables, stats=None):
    """A block's state dict through from_jax's converter `convert`, keyed
    without its prefix."""
    sd = {}
    convert(sd, "blk", variables["params"], stats or variables["batch_stats"])
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


def _check_block(jblock, block, convert, jinputs, train, seed, tol):
    """jblock and the port's `block` (holding the same weights) on the same
    NHWC inputs: outputs within `tol` of the largest magnitude, and in
    training the running statistics within 1e-5 of flax's blend."""
    variables = _block_variables(jblock, *map(jnp.zeros_like, map(jnp.asarray, jinputs)),
                                 seed=seed)
    block.load_state_dict(_block_state_dict(convert, variables), strict=True)
    block.train(train)
    want, mutated = jblock.apply(variables, *map(jnp.asarray, jinputs), train=train,
                                 mutable=["batch_stats"])
    want = np.asarray(want)
    with torch.no_grad():
        got = block(*map(_nchw, jinputs)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    if train:
        want_sd = _block_state_dict(convert, variables, mutated["batch_stats"])
        n = 0
        for name, buf in block.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=name)
                n += 1
        assert n and all(not torch.equal(buf, _block_state_dict(convert, variables)[k])
                         for k, buf in block.named_buffers()
                         if k.endswith(("running_mean", "running_var")))
    return variables, block


# --- blocks at narrow widths -----------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_up_conv_matches_flax(train):
    """UpConv(5 -> 8) from 8px to 16px, float32: 1e-5 of the largest value
    (float32 summation order: 5.2e-7 seen); its parameters at the
    reference's up.1/up.2."""
    x = np.random.default_rng(30).normal(0, 1, (2, 8, 8, 5)).astype(np.float32)
    _, block = _check_block(JB.UpConv(8), TB.UpConv(5, 8), FJ._up_conv, [x], train,
                            31, 1e-5)
    assert sorted(block.state_dict()) == sorted(
        f"up.{i}.{k}" for i, ks in ((1, ("weight", "bias")),
                                    (2, ("weight", "bias", "running_mean",
                                         "running_var", "num_batches_tracked")))
        for k in ks)


@pytest.mark.parametrize("train", [False, True])
def test_attention_gate_matches_flax(train):
    """AttentionGate(g 6, x 5 channels -> F_int 4) at 8px, float32: x * psi
    within 1e-5 of the largest value (1.3e-7 seen), and in training the three
    BatchNorms' statistics (psi's one-channel BN over B*8*8 values)."""
    rng = np.random.default_rng(32)
    g = rng.normal(0, 1, (2, 8, 8, 6)).astype(np.float32)
    x = rng.normal(0, 1, (2, 8, 8, 5)).astype(np.float32)
    _check_block(JB.AttentionGate(4), TB.AttentionGate(6, 5, 4), FJ._attention_gate,
                 [g, x], train, 33, 1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_recurrent_block_matches_flax(train):
    """RecurrentBlock(6, t=5), the static unroll, at 8px: the output within
    1e-5 of the largest value (4.5e-7 seen); in training the one BatchNorm's
    running statistics after its six blends (flax's calls of one module,
    in order) within 1e-5, which six blends of the first application's
    batch statistics would not give."""
    x = np.random.default_rng(34).normal(0, 1, (2, 8, 8, 6)).astype(np.float32)
    variables, block = _check_block(JB.RecurrentBlock(6, t=5), TB.RecurrentBlock(6, t=5),
                                    lambda sd, p, pv, sv: FJ._conv_bn(
                                        sd, f"{p}.conv", pv["conv"], sv["conv"]),
                                    [x], train, 35, 1e-5)
    if train:
        bn = block.conv[1]
        m0 = torch.from_numpy(np.asarray(variables["batch_stats"]["conv"]["bn"]["mean"]))
        with torch.no_grad():
            first = block.conv[0](_nchw(x)).mean(dim=(0, 2, 3))
        once_six_times = 0.9 ** 6 * m0 + (1 - 0.9 ** 6) * first
        assert (bn.running_mean - once_six_times).abs().max() > 1e-2


@pytest.mark.parametrize("train", [False, True])
def test_rrcnn_block_matches_flax(train):
    """RRCNNBlock(4 -> 6, t=5) at 8px: the 1x1 map, two recurrences and the
    residual within 1e-5 of the largest value (3.9e-7 seen); in training both
    recurrences' statistics."""
    x = np.random.default_rng(36).normal(0, 1, (2, 8, 8, 4)).astype(np.float32)
    _, block = _check_block(JB.RRCNNBlock(6, t=5), TB.RRCNNBlock(4, 6, t=5), FJ._rrcnn,
                            [x], train, 37, 1e-5)
    assert sorted({k.rsplit(".", 1)[0] for k in block.state_dict()}) == [
        "RCNN.0.conv.0", "RCNN.0.conv.1", "RCNN.1.conv.0", "RCNN.1.conv.1", "conv_1x1"]


@pytest.mark.parametrize("size", [8, 7, 2])
def test_adaptive_avg_pool_matches_jax(size):
    """To 7x7 from 8x8 (overlapping bins), 7x7 (the identity: the input
    itself, in its dtype) and 2x2 (bins repeat inputs): 1e-6, in float32
    for a bf16 input, as the JAX package pools."""
    x = np.random.default_rng(size).normal(0, 1, (2, size, size, 5)).astype(np.float32)
    want = np.asarray(JB.adaptive_avg_pool(jnp.asarray(x), 7, 7))
    got = TB.adaptive_avg_pool(torch.from_numpy(x), 7, 7)
    assert got.shape == (2, 7, 7, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    xb = torch.from_numpy(x).bfloat16()
    got_b = TB.adaptive_avg_pool(xb, 7, 7)
    if size == 7:
        assert got_b is xb
    else:
        assert got_b.dtype == torch.float32
        want_b = np.asarray(JB.adaptive_avg_pool(jnp.asarray(xb.float().numpy(),
                                                             jnp.bfloat16), 7, 7))
        np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=1e-6)


def test_upsample_nearest2x_matches_jax():
    x = np.random.default_rng(38).normal(0, 1, (2, 3, 5, 4)).astype(np.float32)
    got = TB.upsample_nearest2x(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JB.upsample_nearest2x(jnp.asarray(x))))


# --- the five models at full width --------------------------------------------

# Each model's float32 distance from the port's float64 run of the same
# inputs and weights (32px, B=2; VGG also 64px), as max |a - b| over the
# largest |b| (statistics: max |a - b| / (|b| + 1e-3); gradients: over the
# largest |g|), JAX's / the port's (measured on this CPU):
#   AttentionUNet  eval 3.6e-6 / 1.5e-5  train 4.3e-5 / 5.4e-5
#                  statistics 1.3e-4 / 1.6e-4  gradients 6.1e-3 / 5.2e-3
#   R2Unet         eval 4.6e-6 / 9.4e-6  train 2.3e-6 / 1.6e-6
#                  statistics 2.2e-3 / 1.1e-3  gradients 1.7e-4 / 5.7e-5
#   R2AttUnet      eval 5.5e-6 / 1.1e-5  train 7.2e-6 / 7.2e-6
#                  statistics 6.2e-4 / 4.3e-4  gradients 5.5e-4 / 4.5e-4
#   VGG16 (32/64)  eval 2.5e-6 / 1.9e-6  train 1.4e-5 / 7.3e-6
#                  statistics 2.4e-4 / 2.6e-4  gradients 1.1e-5 / 5.5e-2
#   VGG19          eval 1.2e-6 / 2.0e-6  train 1.4e-5 / 3.8e-5
#                  statistics 4.8e-4 / 5.5e-4  gradients 3.1e-5 / 6.8e-5
# The U-Nets' bottleneck normalizes B*2*2 = 8 values a channel at 32px, so
# their train-mode statistics and gradients are ill-conditioned.  The
# port's float32 VGG16 gradient is 5.5e-2 off because one ReLU input of
# fc2 lies within float32 noise of zero (6e-6 in float32, -2.3e-5 in
# float64) and takes the other side of the kink, which moves a row of
# classifier.3.weight and, through it, every gradient below: a float32
# run of either framework can do that.  So the gradients are held in
# float64 (the port's float64 step against JAX's float32), and the
# float32 step by its loss, parameters and statistics.
# Each tolerance below is three times the larger of the two distances.
TOL = {
    "AttentionUNet": dict(eval=5e-5, train=2e-4, stats=5e-4, grads=2e-2),
    "R2Unet": dict(eval=3e-5, train=1e-5, stats=7e-3, grads=6e-4),
    "R2AttUnet": dict(eval=4e-5, train=3e-5, stats=2e-3, grads=2e-3),
    "VGG16": dict(eval=1e-5, train=5e-5, stats=1e-3, grads=5e-5),
    "VGG19": dict(eval=1e-5, train=2e-4, stats=2e-3, grads=2e-4),
}
FORWARD_CASES = [(name, 32) for name in Z.SEG + Z.CLS] + [(name, 64) for name in Z.CLS]


def _ids(case):
    return f"{case[0]}-{case[1]}px"


def _assert_stats(model, want_sd, tol):
    n = 0
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.double().numpy(), want_sd[name], rtol=tol,
                                       atol=1e-3 * tol, err_msg=name)
            n += 1
    return n


@pytest.mark.parametrize("name", Z.SEG + Z.CLS)
def test_state_dicts_match_the_oracles_and_exporters(name):
    """The port's state dict has the key set of the reference-style oracle
    (tests/torch_oracles.py), from_jax's dict is the JAX exporter's bit for
    bit, and the exporter's dict loads with strict=True."""
    variables = Z.flax_variables(name)
    _, convert, export, oracle = Z.SPECS[name]
    model = get_model(name)["factory"](device="cpu")
    assert set(model.state_dict()) == set(oracle().state_dict())
    exported = export(variables)
    mine = convert(variables)
    assert list(exported) == list(mine) and set(mine) == set(model.state_dict())
    for k, v in exported.items():
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(v), err_msg=k)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in exported.items()},
                          strict=True)


@pytest.mark.parametrize("case", FORWARD_CASES, ids=_ids)
def test_eval_forward_matches_flax(case):
    """Eval mode, float32: logits (float32; [B,H,W,1] for a U-Net, [B,3] for
    VGG) within TOL["eval"] of the largest |logit|."""
    name, size = case
    variables = Z.flax_variables(name)
    x = Z.images(1, size=size)
    want = np.asarray(Z.flax_model(name).apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = Z.port_model(name, variables).eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == ((2, size, size, 1) if name in Z.SEG else (2, 3))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL[name]["eval"] * np.abs(want).max())


@pytest.mark.parametrize("case", FORWARD_CASES, ids=_ids)
def test_train_forward_and_statistics_match_flax(case):
    """Train mode, float32, VGG's dropouts off in both: the logits within
    TOL["train"] of the largest |logit|, and every running statistic
    within TOL["stats"] relative of flax's blend, the R2 blocks' after six
    blends of their one BatchNorm."""
    name, size = case
    variables = Z.flax_variables(name)
    x = Z.images(1, size=size)
    with Z.flax_dropout_off():
        want, mutated = Z.flax_model(name).apply(variables, jnp.asarray(x), train=True,
                                                 mutable=["batch_stats"],
                                                 rngs={"dropout": jax.random.key(0)})
    want = np.asarray(want)
    model = Z.port_model(name, variables).train()
    kw = {"generator": torch.Generator()} if name in Z.CLS else {}
    with torch.no_grad():
        got = model(torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL[name]["train"] * np.abs(want).max())
    want_sd = Z.as_port_names(name, variables["params"], mutated["batch_stats"])
    n = _assert_stats(model, want_sd, TOL[name]["stats"])
    assert n == 2 * sum(isinstance(m, TB.BatchNorm2d) for m in model.modules())


@pytest.mark.parametrize("name", Z.CLS)
def test_head_only_matches_jax_mask(name):
    """VGG's stage-1 rule: the port trains exactly what the JAX mask does,
    the classifier stack (the JAX package's fc1, fc2 and head_fc), name
    for name."""
    variables = Z.flax_variables(name)
    params = variables["params"]
    mask = mask_from_predicate(params, jhead_only(name))
    flags = Z.as_port_names(name, jax.tree.map(lambda m, p: np.full(p.shape, m), mask,
                                               params), variables["batch_stats"])
    model = get_model(name)["factory"](device="cpu")
    trainable = {id(p) for p in set_trainable(model, head_only(name))}
    for pname, p in model.named_parameters():
        want = bool(flags[pname].all())
        assert want == bool(flags[pname].any()), pname
        assert (id(p) in trainable) == p.requires_grad == want, pname
        assert want == pname.startswith("classifier."), pname
    assert len(trainable) == 6
    assert finetune_filter(name) is all_trainable


def test_vgg_dropouts_draw_from_the_generator():
    """VGG16 in training: its three dropouts draw from the generator passed
    (the same seed, the same logits; another seed, others), never from
    torch's global RNG; without a generator it refuses; in eval mode the
    generator changes nothing."""
    model = Z.port_model("VGG16", Z.flax_variables("VGG16"))
    for m, p in zip((m for m in model.modules() if isinstance(m, torch.nn.Dropout)),
                    (0.5, 0.5, 0.5)):
        m.p = p
    x = torch.from_numpy(Z.images(2))
    model.train()
    with torch.no_grad():
        state = torch.get_rng_state()
        a = model(x, generator=torch.Generator().manual_seed(1))
        b = model(x, generator=torch.Generator().manual_seed(1))
        c = model(x, generator=torch.Generator().manual_seed(2))
        assert torch.equal(torch.get_rng_state(), state)
        assert torch.equal(a, b) and not torch.equal(a, c)
        with pytest.raises(ValueError, match="explicit torch.Generator"):
            model(x)
        model.eval()
        assert torch.equal(model(x), model(x, generator=torch.Generator().manual_seed(3)))


@pytest.mark.parametrize("name", ["R2AttUnet", "VGG16"])
def test_init_weights_matches_flax_lecun_normal(name):
    """init_weights covers every module of the new models: each conv and
    Linear weight has flax's lecun_normal std (fan_in = in_channels * kh *
    kw, or in_features) within 5% (four standard errors of the sample std
    for the small ones), every value within the truncation at 2 std,
    biases 0, BatchNorm 1/0/0/1 (R2AttUnet holds every U-Net block, the
    one-output psi projections among them; VGG16 its 25088-input
    classifier.0)."""
    model = init_weights(get_model(name)["factory"](device="cpu"),
                         torch.Generator().manual_seed(0))
    n = 0
    for pname, p in model.named_parameters():
        got = p.detach().numpy()
        if pname.endswith("weight") and p.dim() in (2, 4):
            std = np.sqrt(1.0 / got[0].size)
            # 5%, or four standard errors of a sample std where that is more
            assert abs(got.std() / std - 1) < max(0.05, 4 / np.sqrt(2 * got.size)), pname
            assert np.abs(got).max() <= 2 * std / 0.87962566103423978 * (1 + 1e-6), pname
            n += 1
    for mname, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert (m.weight == 1).all() and not m.bias.any(), mname
            assert not m.running_mean.any() and (m.running_var == 1).all(), mname
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            assert not m.bias.any(), mname
    assert n == sum(isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
                    for m in model.modules())
