"""The opt-in lowering twins against the JAX package's, on the CPU.

The space-to-depth re-layouts (nn/s2d.py, ops/image.py), UpConvS2D,
DoubleConvS2D, ConvT2x2AsDot, the fused AttentionGate, FoldedStem with
augment_batch's and preprocess_eval_batch's `s2d`, and the model flags
(stem_s2d, up_as_dot, s2d_up, fused_gates, use_scan): each against the JAX
twin on weights carried across by interop/from_jax, at the JAX package's
own tolerances (tests/test_s2d.py, test_upt.py, test_fused_gate.py,
test_s2d_stem.py), against the port's default lowering with the same
weights in float64, and a default model's state dict loaded strict into
each twin (the U-Nets with their flags are in
tests/test_torch_twin_models.py).  Then two gloo ranks: the twins'
train-mode statistics at W=2 against one process and against JAX on a
2-device mesh.  Narrow blocks at 8-16px; ResNet18 at full width at 64px,
B=2."""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.core.registry import get_model as jget_model
from medseg_tpu.models.resnet_unet import ConvT2x2AsDot as JConvT2x2AsDot
from medseg_tpu.nn import blocks as JB
from medseg_tpu.nn import s2d as JS
from medseg_tpu.ops import augment as JA
from medseg_tpu.ops import image as JI
from medseg_tpu.parallel import data_parallel_mesh as jmesh_of
from medseg_tpu.parallel import replicated as jreplicated
from medseg_tpu.parallel import shard_batch as jshard_batch
from medseg_tpu_torch.core.registry import get_model
from medseg_tpu_torch.interop import from_jax as FJ
from medseg_tpu_torch.models.resnet_unet import ConvT2x2AsDot
from medseg_tpu_torch.nn import blocks as TB
from medseg_tpu_torch.nn import s2d as TS
from medseg_tpu_torch.nn.blocks import ConvTranspose2d
from medseg_tpu_torch.ops import augment as TA
from medseg_tpu_torch.ops import image as TI
from tests import torch_dist_worker as W
from tests.test_torch_augment import NORM_ATOL, _batch, draw, inject
from tests.test_torch_resnet import flax_resnet
from tests.test_torch_zoo import _block_state_dict, _block_variables

torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --- (a) the re-layouts, exactly -----------------------------------------------------

def test_space_to_depth_orders_match_jax():
    """Both layouts equal JAX's bit for bit, with their channel orders: the
    twins' (dy*2+dx)*C + c (nn/s2d) and the stem's c*4 + dy*2 + dx
    (ops/image); nn/s2d's depth_to_space inverts its space_to_depth."""
    x = np.random.default_rng(0).standard_normal((2, 8, 6, 5)).astype(np.float32)
    tx = torch.from_numpy(x)
    s = TS.space_to_depth(tx)
    assert s.shape == (2, 4, 3, 20)
    np.testing.assert_array_equal(s.numpy(), np.asarray(JS.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(TS.depth_to_space(s).numpy(), x)
    np.testing.assert_array_equal(
        TS.depth_to_space(torch.from_numpy(np.array(JS.space_to_depth(jnp.asarray(x))))).numpy(),
        np.asarray(JS.depth_to_space(JS.space_to_depth(jnp.asarray(x)))))
    stem = TI.space_to_depth(tx)
    np.testing.assert_array_equal(stem.numpy(), np.asarray(JI.space_to_depth(jnp.asarray(x))))
    for c in range(5):
        for dy in range(2):
            for dx in range(2):
                np.testing.assert_array_equal(s[..., (dy * 2 + dx) * 5 + c].numpy(),
                                              x[:, dy::2, dx::2, c])
                np.testing.assert_array_equal(stem[..., c * 4 + dy * 2 + dx].numpy(),
                                              x[:, dy::2, dx::2, c])
    # the stem's order is NCHW pixel_unshuffle's
    np.testing.assert_array_equal(
        torch.nn.functional.pixel_unshuffle(tx.permute(0, 3, 1, 2), 2).numpy(),
        stem.permute(0, 3, 1, 2).numpy())


RELAYOUTS = {"up": (TS.upconv_s2d_kernel, TS.upconv_s2d_weight, JS.upconv_s2d_kernel),
             "conv3x3": (TS.conv3x3_s2d_kernel, TS.conv3x3_s2d_weight,
                         JS.conv3x3_s2d_kernel)}


@pytest.mark.parametrize("kind", sorted(RELAYOUTS))
def test_kernel_relayouts_match_jax_exactly(kind):
    """upconv_s2d_kernel / conv3x3_s2d_kernel on the same float32 [3,3,5,7]
    array equal JAX's bit for bit (aliased taps summed in its order); the
    torch-weight forms are the same re-layout in [Co,Ci,3,3]."""
    port, port_w, jax_fn = RELAYOUTS[kind]
    k = np.random.default_rng(1).standard_normal((3, 3, 5, 7)).astype(np.float32)
    got = port(torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_fn(jnp.asarray(k))))
    w = torch.from_numpy(k).permute(3, 2, 0, 1)
    np.testing.assert_array_equal(port_w(w).numpy(), got.permute(3, 2, 0, 1).numpy())


@pytest.mark.parametrize("kind", sorted(RELAYOUTS))
def test_relayout_gradient_is_its_transpose(kind):
    """The re-layout is linear, so its gradient must be its adjoint:
    <R(K2), G> = <K2, dK> for dK the gradient of <R(K), G> (float64, 1e-12)."""
    _, port_w, _ = RELAYOUTS[kind]
    rng = np.random.default_rng(2)
    k = torch.from_numpy(rng.standard_normal((7, 5, 3, 3))).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal(tuple(port_w(k).shape)))
    (port_w(k) * g).sum().backward()
    k2 = torch.from_numpy(rng.standard_normal((7, 5, 3, 3)))
    lhs, rhs = float((port_w(k2) * g).sum()), float((k2 * k.grad).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_grouped_bn_stats_match_jax_and_the_view():
    """_grouped_bn_stats against JAX's (1e-6: float32 summation order), and
    against the batch statistics the twins' BatchNorm takes of the
    [B,H,4W,C] view of an s2d tensor (momentum 1 leaves them in the
    running buffers): the same per-logical-channel element set."""
    y = np.random.default_rng(3).normal(0.4, 2.0, (2, 4, 5, 4 * 6)).astype(np.float32)
    mean, var = TS._grouped_bn_stats(torch.from_numpy(y), 6)
    jmean, jvar = JS._grouped_bn_stats(jnp.asarray(y), 6)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-6, atol=1e-6)
    bn = TB.BatchNorm2d(6, momentum=1.0).train()
    view = torch.from_numpy(y).reshape(2, 4, 5 * 4, 6).permute(0, 3, 1, 2)
    bn(view)
    np.testing.assert_allclose(bn.running_mean.numpy(), mean.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), var.numpy(), rtol=1e-5, atol=1e-6)


# --- (b) the blocks against the JAX twins ---------------------------------------

def _run_jax(jblock, variables, inputs, **kw):
    """The JAX twin's eval output, train output, new statistics and the
    parameter gradients of mean(train output^2)."""
    ins = [jnp.asarray(a) for a in inputs]

    @jax.jit
    def run(variables, ins):
        evl = jblock.apply(variables, *ins, train=False, **kw)

        def loss(params):
            y, mut = jblock.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  *ins, train=True, mutable=["batch_stats"], **kw)
            return (y.astype(jnp.float32) ** 2).mean(), (y, mut["batch_stats"])

        grads, (out, stats) = jax.grad(loss, has_aux=True)(variables["params"])
        return evl, out, stats, grads

    return jax.device_get(run(variables, ins))


def _run_port(block, sd, inputs, model=False, grads=True, **kw):
    """The port's block (loaded strict from `sd`): the same four things,
    NHWC, the statistics and gradients under its state-dict names.  A
    model takes and returns NHWC itself; a block NCHW views."""
    block.load_state_dict(sd, strict=True)
    ins = [torch.from_numpy(np.asarray(a)) if model else _nchw(a) for a in inputs]
    out_nhwc = (lambda t: t.detach().numpy()) if model else _nhwc
    with torch.no_grad():
        evl = out_nhwc(block.eval()(*ins, **kw))
    with torch.set_grad_enabled(grads):
        out = block.train()(*ins, **kw)
    stats = {k: v.clone() for k, v in block.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    if grads:
        out.float().square().mean().backward()
        grads = {k: p.grad.clone() for k, p in block.named_parameters()}
    return evl, out_nhwc(out), stats, grads


def _check_twin(jblock, block, convert, inputs, tol, seed, stats_tol=None, grad_rtol=0.0,
                **kw):
    """tol: (eval, train, grads) absolute; stats_tol: (rtol, atol)."""
    variables = _block_variables(jblock, *map(jnp.zeros_like, map(jnp.asarray, inputs)),
                                 seed=seed)
    sd = _block_state_dict(convert, variables)
    jevl, jout, jstats, jgrads = _run_jax(jblock, variables, inputs, **kw)
    evl, out, stats, grads = _run_port(block, sd, inputs, **kw)
    np.testing.assert_allclose(evl, np.asarray(jevl), rtol=0, atol=tol[0])
    np.testing.assert_allclose(out, np.asarray(jout), rtol=0, atol=tol[1])
    want_stats = _block_state_dict(convert, variables, jstats)
    rtol, atol = stats_tol or (0.0, 1e-5)
    assert stats
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)
    want_grads = _block_state_dict(convert, {"params": jgrads,
                                             "batch_stats": variables["batch_stats"]})
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), rtol=grad_rtol,
                                   atol=tol[2], err_msg=k)
    return sd


def _assert_same_function(default, twin, sd, inputs, tol=1e-9, model=False, grads=True,
                          **kw):
    """In float64 the twin and the default lowering (both loaded from sd):
    the eval and train outputs, the running statistics after the train
    forward, and (with `grads`) the parameter gradients, within `tol` of
    each one's largest magnitude."""
    runs = [_run_port(m.double(), {k: v.double() if v.is_floating_point() else v
                                   for k, v in sd.items()},
                      [np.asarray(a, np.float64) for a in inputs], model, grads, **kw_)
            for m, kw_ in ((default, {}), (twin, kw))]
    (e0, o0, s0, g0), (e1, o1, s1, g1) = runs
    assert rel(e1, e0) < tol and rel(o1, o0) < tol
    assert s0.keys() == s1.keys()
    for k in s0:
        assert rel(s1[k], s0[k]) < tol, k
    if not grads:
        return
    assert g0.keys() == g1.keys()
    gmax = max(float(g.abs().max()) for g in g0.values())
    for k in g0:
        assert float((g1[k] - g0[k]).abs().max()) < tol * gmax, k


def test_up_conv_s2d_matches_jax_twin():
    """UpConvS2D(10 -> 12) on (2,6,8,10) against JAX's UpConvS2D: eval
    3e-5, train 5e-5, statistics 1e-5, gradients 3e-5 (tests/test_s2d.py's);
    the same function as the port's UpConv in float64; keep_s2d returns
    the s2d layout of the same output, as JAX's."""
    x = np.random.default_rng(3).standard_normal((2, 6, 8, 10)).astype(np.float32)
    block = TS.UpConvS2D(10, 12)
    sd = _check_twin(JS.UpConvS2D(12), block, FJ._up_conv, [x], (3e-5, 5e-5, 3e-5), 40)
    with torch.no_grad():
        kept = block.eval()(_nchw(x), keep_s2d=True)
        full = block(_nchw(x))
    assert kept.shape == (2, 48, 6, 8)
    np.testing.assert_array_equal(TS.depth_to_space(kept.permute(0, 2, 3, 1)).numpy(),
                                  _nhwc(full))
    f64 = torch.float64
    _assert_same_function(TB.UpConv(10, 12, f64), TS.UpConvS2D(10, 12, f64), sd, [x])


def test_double_conv_s2d_matches_jax_twin():
    """DoubleConvS2D(3 -> 12) on (2,12,16,3) against JAX's, at
    tests/test_s2d.py's tolerances; the same function as DoubleConv."""
    x = np.random.default_rng(4).standard_normal((2, 12, 16, 3)).astype(np.float32)
    sd = _check_twin(JS.DoubleConvS2D(12), TS.DoubleConvS2D(3, 12), FJ._double_conv, [x],
                     (3e-5, 5e-5, 3e-5), 41)
    f64 = torch.float64
    _assert_same_function(TB.DoubleConv(3, 12, f64), TS.DoubleConvS2D(3, 12, f64), sd, [x])


def _convt_sd(params):
    sd = {}
    FJ._conv_transpose(sd, "blk", params)
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


def test_conv_t_as_dot_matches_jax_and_reads_torch_taps_unflipped():
    """ConvT2x2AsDot(10 -> 6) on (2,5,9,10) against JAX's ConvT2x2AsDot
    (its output and gradients within test_upt.py's 2e-6) and the port's
    ConvTranspose2d in float64; a delta input puts W[:, :, dy, dx] + b at
    output (2i+dy, 2j+dx): torch's taps, not JAX's flipped ones."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 9, 10)).astype(np.float32)
    jblock = JConvT2x2AsDot(6)
    variables = _block_variables(jblock, jnp.asarray(x), seed=42)
    sd = _convt_sd(variables["params"])
    want = np.asarray(jblock.apply(variables, jnp.asarray(x)))
    block = ConvT2x2AsDot(10, 6)
    block.load_state_dict(sd, strict=True)
    xt = _nchw(x).requires_grad_(False)
    out = block(xt)
    np.testing.assert_allclose(_nhwc(out), want, rtol=0, atol=2e-6)
    jgrads = jax.grad(lambda p: (jblock.apply({"params": p}, jnp.asarray(x)) ** 2).mean())(
        variables["params"])
    want_g = _convt_sd(jax.device_get(jgrads))
    out.square().mean().backward()
    for k, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), rtol=0, atol=2e-6)
    delta = torch.zeros(1, 10, 4, 4)
    delta[0, :, 1, 2] = 1.0
    with torch.no_grad():
        y = block(delta)
    for dy in range(2):
        for dx in range(2):
            np.testing.assert_allclose(
                y[0, :, 2 + dy, 4 + dx].numpy(),
                (block.weight[:, :, dy, dx].sum(0) + block.bias).detach().numpy(),
                rtol=0, atol=2e-6)
    default = ConvTranspose2d(10, 6, 2, 2, compute_dtype=torch.float64).double()
    default.load_state_dict({k: v.double() for k, v in sd.items()}, strict=True)
    twin = ConvT2x2AsDot(10, 6, torch.float64).double()
    twin.load_state_dict(default.state_dict(), strict=True)
    xd = _nchw(x).double()
    assert rel(twin(xd).detach(), default(xd).detach()) < 1e-12


def test_fused_attention_gate_matches_jax_twin():
    """AttentionGate(f_int 8, fused_stats=True) on g, x (2,8,8,16) against
    JAX's fused gate: eval 2e-6, train 1e-5, statistics rtol 1e-5 atol
    1e-6, gradients rtol 2e-4 atol 1e-6 (tests/test_fused_gate.py's);
    the same function as the port's unfused gate in float64."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    sd = _check_twin(JB.AttentionGate(8, fused_stats=True),
                     TB.AttentionGate(16, 16, 8, fused_stats=True), FJ._attention_gate,
                     [g, x], (2e-6, 1e-5, 1e-6), 43, stats_tol=(1e-5, 1e-6),
                     grad_rtol=2e-4)
    _assert_same_function(TB.AttentionGate(16, 16, 8, torch.float64),
                          TB.AttentionGate(16, 16, 8, torch.float64, fused_stats=True), sd,
                          [g, x])


def test_fused_gate_counts_running_statistics_once():
    """One train forward blends W_g's and W_x's running statistics once:
    momentum 1 leaves exactly the batch statistics (a second blend would
    move nothing more at momentum 1, so also hold the default momentum's
    one blend against the unfused gate's)."""
    rng = np.random.default_rng(5)
    g, x = (rng.normal(0.5, 2, (2, 4, 4, 6)), rng.normal(-1, 1, (2, 4, 4, 5)))
    fused = TB.AttentionGate(6, 5, 4, torch.float64, fused_stats=True).double()
    plain = TB.AttentionGate(6, 5, 4, torch.float64).double()
    plain.load_state_dict(fused.state_dict())
    with torch.no_grad():
        fused.train()(_nchw(g), _nchw(x))
        plain.train()(_nchw(g), _nchw(x))
    for k, v in plain.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert rel(fused.state_dict()[k], v) < 1e-12, k


# --- (c) FoldedStem and augmentation's s2d -------------------------------------------

def test_resnet18_stem_s2d_matches_jax():
    """resnet18(stem_s2d=True) on space_to_depth(x) at 64px, B=2, against
    JAX's resnet18(stem_s2d=True) on the same weights, eval mode
    (test_s2d_stem.py's 1e-5, here of the largest logit: these
    He-scaled weights give logits near 40), and against the port's standard stem on x
    in float64 (eval and train forward, 1e-9 of the largest logit)."""
    jmodel, variables = flax_resnet(18)
    x = np.random.default_rng(6).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jget_model("ResNet18")["factory"](stem_s2d=True).apply)(
        variables, JI.space_to_depth(jnp.asarray(x))))
    sd = FJ.resnet_classifier_state_dict(variables, 18)
    model = get_model("ResNet18")["factory"](stem_s2d=True, device="cpu")
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model.eval()(TI.space_to_depth(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    f64 = {k: v.double() if v.is_floating_point() else v for k, v in sd.items()}
    default = get_model("ResNet18")["factory"](dtype=torch.float64, device="cpu").double()
    twin = get_model("ResNet18")["factory"](dtype=torch.float64, device="cpu",
                                            stem_s2d=True).double()
    default.load_state_dict(f64, strict=True)
    twin.load_state_dict(f64, strict=True)
    xd = torch.from_numpy(x).double()
    with torch.no_grad():
        for train in (False, True):
            kw = {"generator": torch.Generator()} if train else {}
            a = default.train(train)(xd, **{k: torch.Generator().manual_seed(0)
                                            for k in kw})
            b = twin.train(train)(TI.space_to_depth(xd), **{k: torch.Generator().manual_seed(0)
                                                           for k in kw})
            assert rel(b, a) < 1e-9, train


def test_augment_batch_s2d_cpu_branch_matches_jax(monkeypatch):
    """augment_batch(s2d=True) on the CPU: JAX's CPU branch on the same
    AugmentParams within NORM_ATOL (the two-pass warp's float32 rounding,
    tests/test_torch_augment.py), and the shuffle of the port's own
    s2d=False output bit for bit (JAX's test: 1e-6).  Masks ignore s2d."""
    images, masks = _batch(8)
    inject(monkeypatch, [draw(9, 3)] * 4)
    jx, _ = jax.jit(functools.partial(JA.augment_batch, s2d=True))(None, jnp.asarray(images))
    tx, tm = TA.augment_batch(torch.Generator(), torch.from_numpy(images), s2d=True)
    plain, _ = TA.augment_batch(torch.Generator(), torch.from_numpy(images))
    assert tx.shape == (3, 16, 16, 12) and tm is None
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=NORM_ATOL)
    assert torch.equal(tx, TI.space_to_depth(plain))
    x_m, m = TA.augment_batch(torch.Generator(), torch.from_numpy(images),
                              torch.from_numpy(masks), s2d=True)
    assert x_m.shape == (3, 32, 32, 3) and m.shape == (3, 32, 32, 1)


def test_augment_batch_s2d_kernel_branch_is_the_shuffle(monkeypatch):
    """The card's branch (the warp's planar output, one permute), forced
    onto CPU tensors where the wrapper runs the plain version: bit for bit
    the shuffle of that branch's NHWC output, in float32 and bfloat16."""
    images, _ = _batch(10, masks=False)
    monkeypatch.setattr(TA, "_on_card", lambda images: True)
    inject(monkeypatch, [draw(11, 3)] * 4)
    for dtype in (torch.float32, torch.bfloat16):
        s2d, _ = TA.augment_batch(torch.Generator(), torch.from_numpy(images),
                                  out_dtype=dtype, s2d=True)
        nhwc, _ = TA.augment_batch(torch.Generator(), torch.from_numpy(images),
                                   out_dtype=dtype)
        assert s2d.dtype == dtype and torch.equal(s2d, TI.space_to_depth(nhwc))


@pytest.mark.parametrize("on_card", [False, True])
def test_preprocess_eval_batch_s2d(monkeypatch, on_card):
    """preprocess_eval_batch(s2d=True) is the shuffle of the plain call bit
    for bit on both branches, and matches JAX's within 1e-6; masks
    ignore it."""
    monkeypatch.setattr(TA, "_on_card", lambda images: on_card)
    images, masks = _batch(12)
    x, _ = TA.preprocess_eval_batch(torch.from_numpy(images), s2d=True)
    plain, _ = TA.preprocess_eval_batch(torch.from_numpy(images))
    assert torch.equal(x, TI.space_to_depth(plain))
    jx, _ = JA.preprocess_eval_batch(jnp.asarray(images), s2d=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    xm, m = TA.preprocess_eval_batch(torch.from_numpy(images), torch.from_numpy(masks),
                                     s2d=True)
    assert xm.shape == (3, 32, 32, 3) and m.shape == (3, 32, 32, 1)


# --- (e) strict loading ------------------------------------------------------------

STRICT_CASES = [("ResNet18", dict(stem_s2d=True)), ("ResNet50", dict(stem_s2d=True)),
                ("ResNetUnet", dict(up_as_dot=True)),
                ("AttentionUNet", dict(s2d_up=True)), ("AttentionUNet", dict(fused_gates=True)),
                ("R2Unet", dict(use_scan=True, s2d_up=True, fused_gates=True)),
                ("R2AttUnet", dict(use_scan=True, s2d_up=True, fused_gates=True))]


@pytest.mark.parametrize("name,flags", STRICT_CASES,
                         ids=[f"{n}-{'-'.join(f)}" for n, f in STRICT_CASES])
def test_twin_loads_a_default_state_dict_strictly(name, flags):
    """Every twin built through the registry has the default model's keys,
    in its order, and loads its state dict with strict=True."""
    factory = get_model(name)["factory"]
    default, twin = factory(device="cpu"), factory(device="cpu", **flags)
    assert list(twin.state_dict()) == list(default.state_dict())
    twin.load_state_dict(default.state_dict(), strict=True)
    assert all(torch.equal(v, twin.state_dict()[k]) for k, v in default.state_dict().items())


# --- (f) W=2 against one process and a JAX mesh ---------------------------------------

def _jax_twins(variables, dtype):
    """flax's fused gate and UpConvS2D in training on the 2-device mesh:
    y, the input and parameter gradients of sum(y * ct), the statistics."""
    g, x, ct_gate, ct_up = W.twin_inputs()
    mesh = jmesh_of(jax.devices()[:2])
    cast = functools.partial(jax.tree.map, lambda a: jnp.asarray(a, dtype))
    out = {}
    for name, block, ins, ct in (("gate", JB.AttentionGate(4, dtype=dtype, fused_stats=True),
                                  (g, x), ct_gate),
                                 ("up", JS.UpConvS2D(8, dtype=dtype), (x,), ct_up)):
        v = variables[name]

        def f(params, *ins, block=block, v=v, ct=ct):
            y, mut = block.apply({"params": params, "batch_stats": cast(v["batch_stats"])},
                                 *ins, train=True, mutable=["batch_stats"])
            return (y * jnp.asarray(ct, dtype)).sum(), (y, mut["batch_stats"])

        (_, (y, stats)), grads = jax.jit(jax.value_and_grad(
            f, tuple(range(len(ins) + 1)), has_aux=True))(
            jax.device_put(cast(v["params"]), jreplicated(mesh)),
            *(jshard_batch(np.asarray(a, dtype), mesh) for a in ins))
        out[name] = jax.device_get((y, grads[1:], grads[0], stats))
    return out


CONVERT = {"gate": FJ._attention_gate, "up": FJ._up_conv}


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """Weights written, the two ranks spawned, and while they run JAX's
    results on the mesh and the port's at W=1 computed here."""
    work = tmp_path_factory.mktemp("twins")
    g, x, _, _ = W.twin_inputs()
    variables = {"gate": _block_variables(JB.AttentionGate(4, fused_stats=True),
                                          jnp.zeros((1, 8, 8, 6)), jnp.zeros((1, 8, 8, 5)),
                                          seed=50),
                 "up": _block_variables(JS.UpConvS2D(8), jnp.zeros((1, 8, 8, 5)), seed=51)}
    for name, v in variables.items():
        torch.save(_block_state_dict(CONVERT[name], v), work / f"twin_{name}.weights.pt")
    with W.spawn_ranks(work, ["twins"]) as collect:
        jres = _jax_twins(variables, jnp.float32)
        one = W.case_twins(W.WORLD1, work)
        ranks = collect()["twins"]
    return {"ranks": ranks, "one": one, "jax": jres, "variables": variables}


@pytest.mark.parametrize("tag,tol", [("f64", 1e-10), ("f32", 2e-5)])
@pytest.mark.parametrize("name", ["gate", "up"])
def test_twins_statistics_are_global_under_two_ranks(dist_run, name, tag, tol):
    """The fused gate and UpConvS2D in training at W=2 (each rank on its
    rows of a global batch of 8): the output and input gradients row for
    row, the parameter gradients summed over the ranks, and the running
    statistics on each rank, against one process on the global batch
    (1e-10 in float64, 2e-5 in float32: test_torch_parallel.py's bounds)
    and against flax's twins on a 2-device mesh (2e-5: JAX computes their
    statistics in float32 whatever the dtype); relative to each tensor's
    largest value (the gradients to the largest parameter gradient).  A
    rank that took its statistics over its own rows alone misses both."""
    ranks = [r[f"{tag}/{name}"] for r in dist_run["ranks"]]
    one = dist_run["one"][f"{tag}/{name}"]
    y, dins, gparams, stats = dist_run["jax"][name]
    jtol = 2e-5
    cat = lambda key: np.concatenate([r[key] for r in ranks])  # noqa: E731
    assert rel(cat("y"), one["y"]) < tol and rel(cat("y"), y) < jtol
    for i, d in enumerate(dins):
        assert rel(cat(f"d{i}"), one[f"d{i}"]) < tol and rel(cat(f"d{i}"), d) < jtol
    v = dist_run["variables"][name]
    want_g = _block_state_dict(CONVERT[name], {"params": gparams,
                                               "batch_stats": v["batch_stats"]})
    want_s = _block_state_dict(CONVERT[name], v, stats)
    gmax = max(float(np.abs(t.numpy()).max()) for k, t in want_g.items()
               if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    grads = [k[5:] for k in one if k.startswith("grad/")]
    assert grads
    for k in grads:
        total = sum(r[f"grad/{k}"] for r in ranks)
        assert np.abs(total - one[f"grad/{k}"]).max() < tol * gmax, k
        assert np.abs(total - want_g[k].numpy()).max() < jtol * gmax, k
    buffers = [k[7:] for k in one if k.startswith("buffer/")]
    assert buffers
    for k in buffers:
        for r in ranks:
            assert rel(r[f"buffer/{k}"], one[f"buffer/{k}"]) < tol, k
            assert rel(r[f"buffer/{k}"], want_s[k].numpy()) < jtol, k


# --- chip_smoke.py's T2 rule ----------------------------------------------------------

def test_chip_smoke_t2_rule_takes_the_largest_order():
    """T2's float32 comparison (chip_smoke._twin_compare): each part of the
    twin's run within `factor` times the largest distance of the default's
    float32 runs from float64, in max and in L2; the verdict follows the
    largest order, so an order that lands on the far side of a ReLU (the
    CPU's) lets a twin that did the same pass."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as C

    ref = {"gradients": {"w": torch.tensor([1.0, 2.0], dtype=torch.float64)}}

    def run(offset):
        return {"gradients": {"w": ref["gradients"]["w"] + torch.tensor(
            [offset, 0.0], dtype=torch.float64)}}

    near = [("card, row order 0", run(1e-6)), ("card, row order 1", run(2e-6))]
    assert C._twin_compare(run(3e-6), ref, near, 2.0)["gradients"][0]
    assert not C._twin_compare(run(5e-6), ref, near, 2.0)["gradients"][0]
    far = near + [("CPU at 1 threads", run(1e-3))]
    ok, line = C._twin_compare(run(1.5e-3), ref, far, 2.0)["gradients"]
    assert ok and "CPU at 1 threads" in line
    assert not C._twin_compare(run(2.5e-3), ref, far, 2.0)["gradients"][0]
