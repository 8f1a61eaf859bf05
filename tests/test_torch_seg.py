"""The port's segmentation slice against the JAX package's, module by module:
synthetic_seg, the segmentation losses, DoubleConv, ResNetUnet (eval and
train mode, weights carried by interop/from_jax and by the JAX package's
export_resnet_unet), the frozen-encoder train step, the eval step, the
segmentation metrics and finetune_filter, on the same numpy inputs at 64px
(ResNetUnet needs a multiple of 32), B=2."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.data.synthetic import synthetic_seg as jsynthetic_seg
from medseg_tpu.eval import metrics as JM
from medseg_tpu.interop.export_torch import export_resnet_unet
from medseg_tpu.models import resnet as jresnet
from medseg_tpu.models.resnet_unet import DecoderBlock as JDecoderBlock
from medseg_tpu.models.resnet_unet import ResNetUnet as JResNetUnet
from medseg_tpu.nn.blocks import DoubleConv as JDoubleConv
from medseg_tpu.train import losses as JL
from medseg_tpu.train import steps as JS
from medseg_tpu.train.freeze import finetune_filter as jfinetune_filter
from medseg_tpu.train.freeze import mask_from_predicate
from medseg_tpu_torch.data.synthetic import synthetic_seg
from medseg_tpu_torch.eval import metrics as TM
from medseg_tpu_torch.interop import from_jax
from medseg_tpu_torch.interop.from_jax import resnet_unet_state_dict
from medseg_tpu_torch.models import resnet as tresnet
from medseg_tpu_torch.models import resnet_unet as tunet
from medseg_tpu_torch.nn.blocks import ConvTranspose2d, DoubleConv
from medseg_tpu_torch.train import losses as TL
from medseg_tpu_torch.train import steps as TS
from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable
from tests.test_torch_resnet import _random_leaf

torch.set_num_threads(1)

SIZE, B = 64, 2
LR, WD, CLIP = 1e-3, 5e-4, 1.0


def _images(seed, b=B, size=SIZE, c=3):
    return np.random.default_rng(seed).normal(0, 1, (b, size, size, c)).astype(np.float32)


def _masks(seed, b=B):
    """Binary float masks [B,H,W,1]: a random square each."""
    rng = np.random.default_rng(seed)
    m = np.zeros((b, SIZE, SIZE, 1), np.float32)
    for i in range(b):
        y, x = rng.integers(0, SIZE // 2, 2)
        m[i, y:y + SIZE // 2, x:x + SIZE // 2] = 1.0
    return m


def _random_variables(model, *inputs, seed=0):
    """numpy variables of a flax `model`: the tree of its own init (traced
    for shapes only), filled from `seed` as test_torch_resnet fills it."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *inputs))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _random_leaf(rng, p, s.shape).astype(np.float32), shapes)


@functools.lru_cache(maxsize=None)
def flax_unet():
    return JResNetUnet(), _random_variables(JResNetUnet(), jnp.zeros((1, SIZE, SIZE, 3)))


def port_unet(variables, dtype=torch.float32):
    model = tunet.resnet_unet(dtype=dtype, device="cpu")
    model.load_state_dict(resnet_unet_state_dict(variables), strict=True)
    return model


def _as_port_names(params, batch_stats):
    sd = resnet_unet_state_dict({"params": params, "batch_stats": batch_stats})
    return {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _is_encoder(name):
    return name.split(".", 1)[0] in {f"encoder{i}" for i in range(1, 6)}


# --- data, losses, metrics ----------------------------------------------------

def test_synthetic_seg_is_byte_equal_to_jax():
    for n, size, seed in ((8, 64, 0), (5, 32, 3)):
        got, want = synthetic_seg(n, size, seed), jsynthetic_seg(n, size, seed)
        for field in ("images", "masks", "labels"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    assert set(np.unique(got.masks)) == {0, 255}


def test_losses_match_jax_on_full_and_padded_batches():
    """BCE, masked BCE, batch IoU and masked batch IoU against the JAX
    package's on logits that reach the sigmoid's tails (|x| up to 40):
    1e-5 relative (the same float32 formulas; the BCE's mean sums 12288
    terms in another order, 2.4e-6 apart here); with n_valid=2 of 3 rows
    the masked forms equal the unmasked ones over the 2 real rows."""
    rng = np.random.default_rng(1)
    logits = (rng.normal(0, 8, (3, SIZE, SIZE, 1)) * (rng.random((3, 1, 1, 1)) + 0.5)
              ).astype(np.float32)
    logits[0, :2, :2] = [[40.0], [-40.0]]
    masks = (rng.random((3, SIZE, SIZE, 1)) > 0.6).astype(np.float32)
    tl, tm = torch.from_numpy(logits), torch.from_numpy(masks)
    jl, jm = jnp.asarray(logits), jnp.asarray(masks)
    np.testing.assert_allclose(TL.bce_with_logits(tl, tm).item(),
                               float(JL.bce_with_logits(jl, jm)), rtol=1e-5)
    probs = torch.sigmoid(tl)
    np.testing.assert_allclose(TL.batch_iou(probs, tm).item(),
                               float(JL.batch_iou(jax.nn.sigmoid(jl), jm)), rtol=1e-6)
    for n_valid in (3, 2):
        valid = TL.valid_mask(3, n_valid)
        jvalid = JL.valid_mask(3, n_valid)
        bce = TL.masked_bce_with_logits(tl, tm, valid).item()
        iou = TL.masked_batch_iou(probs, tm, valid).item()
        np.testing.assert_allclose(
            bce, float(JL.masked_bce_with_logits(jl, jm, jvalid)), rtol=1e-5)
        np.testing.assert_allclose(
            iou, float(JL.masked_batch_iou(jax.nn.sigmoid(jl), jm, jvalid)), rtol=1e-6)
        np.testing.assert_allclose(
            bce, TL.bce_with_logits(tl[:n_valid], tm[:n_valid]).item(), rtol=1e-5)
        np.testing.assert_allclose(
            iou, TL.batch_iou(probs[:n_valid], tm[:n_valid]).item(), rtol=1e-6)
    # bf16 logits are computed in float32
    assert TL.bce_with_logits(tl.bfloat16(), tm).dtype == torch.float32


def test_segmentation_metrics_match_jax():
    """Per-sample vectors: 1e-5 relative (the same float32 formulas); the
    split's means in float64, with and without a pad mask."""
    rng = np.random.default_rng(2)
    probs = rng.random((4, SIZE, SIZE, 1)).astype(np.float32)
    probs[3] = 0.0  # an empty prediction: the EPS terms decide
    target = (rng.random((4, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
    for threshold in (0.5, 0.8):
        got = TM.segmentation_metrics_batched(torch.from_numpy(probs),
                                              torch.from_numpy(target), threshold)
        want = JM.segmentation_metrics_batched(jnp.asarray(probs), jnp.asarray(target),
                                               threshold)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.float32 and got[k].shape == (4,)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       err_msg=k)
        per_sample = {k: v.numpy() for k, v in got.items()}
        for valid in (None, [True, True, False, True]):
            assert (TM.average_segmentation_metrics(per_sample, valid)
                    == JM.average_segmentation_metrics(per_sample, valid))


# --- blocks and the model -------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_double_conv_matches_flax(train):
    """DoubleConv(5 -> 8) at 16px, float32: 1e-4 (summation order); in
    training, the running statistics too (1e-5)."""
    jblock = JDoubleConv(8)
    x = _images(3, size=16, c=5)
    variables = _random_variables(jblock, jnp.zeros((1, 16, 16, 5)), seed=4)
    sd = {}
    from_jax._double_conv(sd, "block", variables["params"], variables["batch_stats"])
    block = DoubleConv(5, 8)
    block.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    assert sorted({k.split(".")[0] for k in block.state_dict()}) == ["0", "1", "3", "4"]
    block.train(train)
    want, mutated = jblock.apply(variables, jnp.asarray(x), train=train,
                                 mutable=["batch_stats"])
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if train:
        want_sd = {}
        from_jax._double_conv(want_sd, "block", variables["params"],
                              mutated["batch_stats"])
        for name, buf in block.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buf.numpy(), want_sd[f"block.{name}"].numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=name)


def test_encoder_taps_match_flax():
    """ResNetEncoder(..., taps=True): e1 before the max pool (64 channels at
    H/2) and the four stages, NHWC, 1e-4 of each tap's largest magnitude;
    skip_stem with taps is refused, as in the JAX package."""
    _, variables = flax_unet()
    x = _images(5)
    enc = jresnet.ResNetEncoder(jresnet.Bottleneck, (3, 4, 6, 3))
    want = enc.apply({k: v["encoder"] for k, v in variables.items()}, jnp.asarray(x),
                     train=False, taps=True)
    port = port_unet(variables).eval()
    with torch.no_grad():
        got = tresnet.ResNetEncoder.forward(port, torch.from_numpy(x), taps=True)
    assert [tuple(t.shape) for t in got] == [(B, 32, 32, 64), (B, 16, 16, 256),
                                            (B, 8, 8, 512), (B, 4, 4, 1024),
                                            (B, 2, 2, 2048)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    with pytest.raises(ValueError, match="pre-pool tap"):
        tresnet.ResNetEncoder.forward(port, torch.zeros(1, 16, 16, 64), skip_stem=True,
                                      taps=True)


def test_eval_forward_matches_flax():
    """ResNetUnet float32 eval mode: float32 [B,H,W,1] logits within 1e-4 of
    the largest |logit| (float32 through 60 layers, summation order)."""
    model, variables = flax_unet()
    x = _images(6)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port_unet(variables).eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (B, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_train_forward_and_statistics_match_flax():
    """Train mode: logits within 1e-3 of the largest |logit|, and every
    running statistic (encoder and decoder) within 1e-3 relative of flax's
    biased-variance blend.  The train-mode forward at 64px, B=2 is
    ill-conditioned in float32: the last stage normalizes 8 values a
    channel, and flax's float32 logits are 2.9e-4 of the largest |logit|
    from a float64 run of the port (the port's float32 ones 0.9e-4); the
    last stage's running variances differ by up to 1.8e-4 relative."""
    model, variables = flax_unet()
    x = _images(7)
    want, mutated = model.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    want = np.asarray(want)
    port = port_unet(variables).train()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * np.abs(want).max())
    want_sd = _as_port_names(variables["params"], mutated["batch_stats"])
    n = 0
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_sd[name], rtol=1e-3, atol=1e-4,
                                       err_msg=name)
            n += 1
    assert n == 2 * (53 + 9)  # 53 BatchNorms in the encoder, 9 in the decoder


def test_export_resnet_unet_loads_strictly():
    """A state dict from the JAX package's export_resnet_unet (the
    reference's .pt layout) loads with strict=True and equals
    resnet_unet_state_dict bit for bit, the transposed convs' flip
    included."""
    _, variables = flax_unet()
    exported = export_resnet_unet(variables)
    mine = resnet_unet_state_dict(variables)
    assert list(exported) == list(mine)
    for k, v in exported.items():
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(v), err_msg=k)
    model = tunet.resnet_unet(device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in exported.items()},
                          strict=True)
    w = np.asarray(variables["params"]["decoder5"]["up"]["kernel"])
    got = model.decoder5.up_sample.weight.detach().numpy()
    np.testing.assert_array_equal(got[:, :, 0, 1], w[1, 0])  # the flip


def test_conv_transpose_tap_mapping_matches_flax():
    """A delta input through one DecoderBlock's up_sample: out[2i+dy,
    2j+dx] = x[i,j] @ W[1-dy,1-dx] in flax (tests/test_upt.py); the port's
    weights from from_jax give the same 2x2 cell, so each sub-position gets
    its own weights."""
    jblock = JDecoderBlock(4)
    down, skip = jnp.zeros((1, 3, 3, 6)), jnp.zeros((1, 6, 6, 2))
    variables = _random_variables(jblock, down, skip, seed=9)
    delta = np.zeros((1, 3, 3, 6), np.float32)
    delta[0, 1, 2, 3] = 1.0
    want = variables["params"]["up"]["kernel"]
    sd = {}
    from_jax._conv_transpose(sd, "up", variables["params"]["up"])
    up = ConvTranspose2d(6, 6, 2, 2)
    up.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = up(torch.from_numpy(delta).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    bias = np.asarray(variables["params"]["up"]["bias"])
    for dy in (0, 1):
        for dx in (0, 1):
            np.testing.assert_allclose(out[0, 2 + dy, 4 + dx].numpy() - bias,
                                       want[1 - dy, 1 - dx, 3], rtol=1e-6, atol=1e-6)


def test_init_weights_scales_transposed_convs_as_flax():
    """init_weights on a DecoderBlock: the transposed conv's weight has
    flax's lecun_normal std (fan_in = in_channels * 4) within 5% of flax's
    init of the same block; its bias 0."""
    jblock = JDecoderBlock(16)
    jvars = jblock.init(jax.random.key(0), jnp.zeros((1, 4, 4, 64)), jnp.zeros((1, 8, 8, 8)))
    block = tunet.DecoderBlock(64, 8, 16)
    tresnet.init_weights(block, torch.Generator().manual_seed(0))
    got = block.up_sample.weight.detach().numpy()
    want = np.asarray(jvars["params"]["up"]["kernel"])
    assert abs(got.std() / want.std() - 1) < 0.05
    assert abs(got.std() / np.sqrt(1.0 / (64 * 4)) - 1) < 0.05
    assert not block.up_sample.bias.detach().any()


# --- freezing and the steps -----------------------------------------------------

def test_finetune_filter_matches_jax_mask():
    """The port's trainable set equals the JAX package's optimizer mask,
    name for name: every decoder parameter, no encoder one."""
    _, variables = flax_unet()
    params = variables["params"]
    mask = mask_from_predicate(params, jfinetune_filter("ResNetUnet"))
    as_arrays = jax.tree.map(lambda m, p: np.full(p.shape, m), mask, params)
    flags = resnet_unet_state_dict({"params": as_arrays,
                                    "batch_stats": variables["batch_stats"]})
    model = tunet.resnet_unet(device="cpu")
    trainable = {id(p) for p in set_trainable(model, finetune_filter("ResNetUnet"))}
    names = dict(model.named_parameters())
    assert set(names) <= set(flags)
    for name, p in names.items():
        want = bool(flags[name].all())
        assert want == bool(flags[name].any()), name
        assert (id(p) in trainable) == p.requires_grad == want, name
        assert want == (not _is_encoder(name)), name
    assert finetune_filter("ResNet18")("layer1.0.conv1.weight")
    # CLIPSeg's rule (ROADMAP A.13, held against JAX's mask in
    # tests/test_torch_finetune.py): the decoder only
    assert finetune_filter("CLIPSeg")("decoder.film_mul.weight")
    assert not finetune_filter("CLIPSeg")("clip.vision_model.pre_layrnorm.weight")


@functools.lru_cache(maxsize=None)
def _jax_seg_step():
    """One JAX seg_train_body step (prep=None) from the test variables on a
    pre-augmented batch: (the state after it, its loss, the step's
    clipped gradients)."""
    model, variables = flax_unet()
    params = variables["params"]
    mask = mask_from_predicate(params, jfinetune_filter("ResNetUnet"))
    opt = JS.build_optimizer(LR, WD, CLIP, mask)
    state = JS.init_state(model, jax.tree.map(jnp.asarray, variables), opt)
    x, m = jnp.asarray(_images(8)), jnp.asarray(_masks(8))

    def loss_fn(p):
        out, _ = model.apply({"params": p, "batch_stats": state.batch_stats}, x,
                             train=True, mutable=["batch_stats"])
        return JL.bce_with_logits(out, m)

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(state.params))
    leaves = [g for g, t in zip(jax.tree.leaves(grads), jax.tree.leaves(mask)) if t]
    norm = float(np.sqrt(sum(float(np.sum(np.square(g))) for g in leaves)))
    scale = min(1.0, CLIP / norm)
    clipped = jax.tree.map(lambda g, t: np.asarray(g) * scale if t else np.zeros_like(g),
                           grads, mask)
    new_state, loss = jax.jit(JS.seg_train_body(model, opt))(state, x, m,
                                                            jax.random.key(0))
    return jax.device_get(new_state), float(loss), clipped, norm


def test_seg_train_step_matches_jax():
    """One seg_train_step (frozen encoder, clip 1.0, AdamW lr 1e-3, wd 5e-4)
    against the JAX package's seg_train_body on the same weights and batch:
    - the loss: 1e-5 relative;
    - the clipped gradients of the decoder: 5e-3 of the largest |g|.  The
      train-mode gradient is ill-conditioned in float32 (see above): JAX's
      own float32 gradients are 2.2e-3 of the largest |g| from a float64
      run of the port, the port's 1.3e-3, and the two 2.2e-3 apart.  The
      encoder has none (requires_grad False);
    - the decoder's parameters after the step: none off by more than 2*lr,
      and within 1e-6 + 2% of lr wherever |g| exceeds ten times the
      gradients' tolerance.  AdamW's first step moves each element by
      about lr*sign(g) whatever its gradient's size, so where |g| is within
      float32 noise of zero (most of decoder5's 28M weights: their median
      |g| is ~1e-5 of the largest) either framework moves it by +-lr;
    - the encoder's parameters bit for bit unchanged;
    - every running statistic, the frozen encoder's too, within 1e-3
      relative of flax's updated batch_stats, and the encoder's moved."""
    state, loss, clipped, norm = _jax_seg_step()
    assert norm > CLIP  # the clip fires
    _, variables = flax_unet()
    model = port_unet(variables).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = TS.build_optimizer(LR, WD, CLIP, set_trainable(model, finetune_filter("ResNetUnet")))
    got = TS.seg_train_step(model, opt, torch.from_numpy(_images(8)),
                            torch.from_numpy(_masks(8)), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.item(), loss, rtol=1e-5)

    want_grads = _as_port_names(clipped, state.batch_stats)
    names = dict(model.named_parameters())
    gmax = max(np.abs(want_grads[n]).max() for n in names)
    final = _as_port_names(state.params, state.batch_stats)
    n_sure = 0
    for name, p in names.items():
        if _is_encoder(name):
            assert p.grad is None and not p.requires_grad, name
            assert torch.equal(p.detach(), before[name]), name
            np.testing.assert_array_equal(p.detach().numpy(), final[name], err_msg=name)
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name], rtol=0,
                                   atol=5e-3 * gmax, err_msg=name)
        diff = np.abs(p.detach().numpy() - final[name])
        assert diff.max() <= 2 * LR, (name, diff.max())
        sure = np.abs(want_grads[name]) > 10 * 5e-3 * gmax
        assert (diff[sure] <= 1e-6 + 0.02 * LR).all(), name
        n_sure += int(sure.sum())
    assert n_sure >= 50  # 85 here: the largest gradients are few
    moved = 0
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), final[name], rtol=1e-3, atol=1e-4,
                                       err_msg=name)
            moved += _is_encoder(name) and not torch.equal(buf, before[name])
    assert moved == 2 * 53


def test_seg_eval_step_matches_jax_on_a_padded_batch():
    """Rows past n_valid (repeats of the last real sample) add nothing:
    loss_sum 1e-5 relative against make_seg_eval_step; the IoU equal to
    1e-6; with n_valid=2 of 3 rows both equal the unpadded batch's."""
    model, variables = flax_unet()
    x, m = _images(9, b=3), _masks(9, b=3)
    x[2], m[2] = x[1], m[1]
    step = JS.make_seg_eval_step(model)
    port = port_unet(variables).eval()
    results = {}
    for n_valid, rows in ((2, 3), (2, 2), (3, 3)):
        loss_sum, iou = step(variables["params"], variables["batch_stats"],
                             jnp.asarray(x[:rows]), jnp.asarray(m[:rows]), n_valid)
        t_loss, t_iou = TS.seg_eval_step(port, torch.from_numpy(x[:rows]),
                                         torch.from_numpy(m[:rows]), n_valid)
        np.testing.assert_allclose(t_loss.item(), float(loss_sum), rtol=1e-5)
        np.testing.assert_allclose(t_iou.item(), float(iou), rtol=0, atol=1e-6)
        results[(n_valid, rows)] = (t_loss.item(), t_iou.item())
    np.testing.assert_allclose(results[(2, 3)], results[(2, 2)], rtol=1e-6)
