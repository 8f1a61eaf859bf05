"""The port's CLIP and CLIPSeg finetuners (ROADMAP A.13) against the JAX
package's on the CPU: the dice and combined losses and their masked forms,
both freeze rules against JAX's optimizer masks, one step of each recipe,
the padded-tail step against the ragged one, 2-epoch runs of both
finetuners with ragged tails, the aux tensors through save_best ->
load_model_bundle -> evaluate_model and Pipeline with no prompt ids, and
split_train_val.

The towers are tests/torch_clip_helpers.py's tiny ones, the weights flax's
init carried by interop/from_jax, the inputs numpy draws from a seed.
Packed CLIP batches are 40px (bicubic down to the 32px grid, as 256 -> 224),
CLIPSeg's 20px (up to its 48px grid and the masks up to its 24px logit
grid, as 256 -> 352).  The one-step tolerances were measured against
float64 runs of the port on the CPU: one CLIP step's clipped gradients
were 1.1e-7 (JAX) and 1.4e-7 (port) from float64 with |g|max 0.24, the
losses 6.0e-7 and 2.4e-7; each check allows about three times the larger
distance measured for its quantity.  The 2-epoch runs hold the port's
updates to JAX's at about ten times the distance measured between them.
The numbers are beside each tolerance.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medseg_tpu.data.loader import BatchLoader as JBatchLoader
from medseg_tpu.data.loader import split_train_val as jsplit_train_val
from medseg_tpu.data.synthetic import synthetic_cls as jsynthetic_cls
from medseg_tpu.data.synthetic import synthetic_seg as jsynthetic_seg
from medseg_tpu.ops.clip_prep import clip_preprocess as jclip_preprocess
from medseg_tpu.train import clip_finetune as jclip_ft
from medseg_tpu.train import clipseg_finetune as jclipseg_ft
from medseg_tpu.train import losses as JL
from medseg_tpu.train import steps as JS
from medseg_tpu.train.freeze import finetune_filter as jfinetune_filter
from medseg_tpu.train.freeze import mask_from_predicate
from medseg_tpu_torch.core.config import (CLIPFinetuneConfig, CLIPSegFinetuneConfig,
                                          EvalConfig)
from medseg_tpu_torch.core.precision import full_float32
from medseg_tpu_torch.data.loader import BatchLoader, split_train_val
from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg
from medseg_tpu_torch.eval.harness import evaluate_model, load_model_bundle
from medseg_tpu_torch.infer.pipeline import Pipeline
from medseg_tpu_torch.interop.from_jax import clip_classifier_state_dict, clipseg_state_dict
from medseg_tpu_torch.models.clip import CLIPClassifier
from medseg_tpu_torch.models.clipseg import CLIPSegModel
from medseg_tpu_torch.train import checkpoint as ckpt
from medseg_tpu_torch.train import losses as L
from medseg_tpu_torch.train import steps as S
from medseg_tpu_torch.train.clip_finetune import clip_train_step, finetune_clip
from medseg_tpu_torch.train.clipseg_finetune import (clipseg_prep, clipseg_train_step,
                                                     finetune_clipseg, pad_rows)
from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable
from tests.torch_clip_helpers import CLIP_GRID, CLIPSEG_GRID, PROJ, SEG, TT, TV
from tests.torch_clip_helpers import clipseg_variables as clipseg_vars
from tests.torch_clip_helpers import JTinyClassifier, JTinyCLIPSeg, tiny_clip_patched

CLIP_PX, SEG_PX = 40, 20  # packed sizes: CLIP resizes down, CLIPSeg up
LR, WD = 1e-3, 5e-4


def _tf(seed=0):
    tf = np.random.default_rng(seed).standard_normal((3, PROJ)).astype(np.float32)
    return tf / np.linalg.norm(tf, axis=-1, keepdims=True)


def _cond(seed=1):
    return np.random.default_rng(seed).standard_normal((1, PROJ)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def clip_vars():
    """flax init of the tiny CLIPClassifier."""
    v = JTinyClassifier().init(jax.random.key(0), jnp.zeros((1, CLIP_GRID, CLIP_GRID, 3)),
                               jnp.asarray(_tf()))
    return jax.tree.map(np.asarray, v)


def port_clip(dtype=torch.float32):
    model = CLIPClassifier(TV, PROJ)
    model.load_state_dict(clip_classifier_state_dict(clip_vars()), strict=True)
    return model.to(dtype)


def port_clipseg(dtype=torch.float32):
    model = CLIPSegModel(TV, TT, PROJ, **SEG)
    model.load_state_dict(clipseg_state_dict(clipseg_vars()), strict=True)
    return model.to(dtype)


def _images(n, px, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, px, px, 3), dtype=np.uint8)


def _masks(n, px, seed):
    return (np.random.default_rng(seed).random((n, px, px)) > 0.5).astype(np.uint8) * 255


# --- losses -------------------------------------------------------------------------

LOSSES = {
    "dice": (L.dice_loss, JL.dice_loss, False),
    "combined": (L.combined_loss, JL.combined_loss, False),
    "masked_dice": (L.masked_dice_loss, JL.masked_dice_loss, True),
    "masked_combined": (L.masked_combined_loss, JL.masked_combined_loss, True),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    """The same logits and targets [4, 24, 24]: one value over the whole
    batch (the masked forms over rows 0-2 of 4).  float32 sums of 2304
    elements: JAX and the port within 4.8e-8 of float64 (measured); tol
    2e-7."""
    ours, theirs, masked = LOSSES[name]
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((4, 24, 24)) * 3).astype(np.float32)
    targets = rng.random((4, 24, 24)).astype(np.float32)
    args = [torch.from_numpy(logits), torch.from_numpy(targets)]
    jargs = [jnp.asarray(logits), jnp.asarray(targets)]
    if masked:
        args.append(L.valid_mask(4, 3))
        jargs.append(JL.valid_mask(4, 3))
    got, want = float(ours(*args)), float(theirs(*jargs))
    ref = float(ours(*[a.double() for a in args]))
    assert abs(got - want) <= 2e-7 and abs(got - ref) <= 2e-7, (got, want, ref)
    if masked:  # pad rows add nothing: the ragged rows' unmasked value
        unmasked = LOSSES[name.replace("masked_", "")][0]
        trimmed = float(unmasked(args[0][:3], args[1][:3]))
        assert abs(got - trimmed) <= 2e-7


# --- freezing -----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CLIP", "CLIPSeg"])
def test_finetune_filter_matches_jax_mask(name):
    """The trainable set equals mask_from_predicate of the JAX rule on the
    same tree, key for key: CLIP's vision tower only (not the projection or
    logit_scale), CLIPSeg's decoder only."""
    variables, to_sd, model, prefix = (
        (clip_vars(), clip_classifier_state_dict, port_clip(), "vision_model.")
        if name == "CLIP" else
        (clipseg_vars(), clipseg_state_dict, port_clipseg(), "decoder."))
    params = variables["params"]
    mask = mask_from_predicate(params, jfinetune_filter(name))
    flags = to_sd({"params": jax.tree.map(lambda m, p: np.full(np.shape(p), m), mask, params)})
    trainable = {id(p) for p in set_trainable(model, finetune_filter(name))}
    names = dict(model.named_parameters())
    assert set(names) == set(flags)
    for key, p in names.items():
        want = key.startswith(prefix)
        assert (id(p) in trainable) == p.requires_grad == want, key
        assert bool(flags[key].all()) == bool(flags[key].any()) == want, key
    assert any(k.startswith(prefix) for k in flags)


# --- one step -----------------------------------------------------------------------

def _jax_step(model, variables, name, loss_fn):
    """One JAX step as the finetuner takes it: (loss, clipped gradients,
    parameters after it) as port-named state dicts."""
    params = variables["params"]
    mask = mask_from_predicate(params, jfinetune_filter(name))
    opt = JS.build_optimizer(LR, WD, 1.0, mask)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    new = optax.apply_updates(params, updates)
    flat = [(g, m) for g, m in zip(jax.tree.leaves(grads), jax.tree.leaves(mask)) if m]
    norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g, _ in flat)))
    scale = min(1.0, 1.0 / norm)
    clipped = jax.tree.map(lambda g, m: np.asarray(g) * scale if m else np.zeros_like(g),
                           grads, mask)
    return float(loss), clipped, jax.tree.map(np.asarray, new)


def _check_step(got_loss, model, want_loss, want_grads, want_params, tol_g, tol_loss):
    """Loss and clipped gradients within their tolerances; each parameter
    exactly where its gradient is above 10x the gradient tolerance (AdamW's
    first step is lr*sign(g)), within 2*lr elsewhere; frozen ones
    untouched."""
    assert abs(got_loss - want_loss) <= tol_loss, (got_loss, want_loss)
    moved = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None
            continue
        g, want_g = p.grad.double(), want_grads[name].double()
        assert float((g - want_g).abs().max()) <= tol_g, name
        big = want_g.abs() > 10 * tol_g
        diff = (p.detach().double() - want_params[name].double()).abs()
        assert not big.any() or float(diff[big].max()) <= 1e-6, name
        assert float(diff.max()) <= 2 * LR + 1e-6, name
        moved += int(big.sum())
    assert moved > 0


def test_clip_step_matches_jax():
    """One finetune step (clip_preprocess 40 -> 32, CE, clip, AdamW over the
    vision tower): loss within 2e-6 (float64 distances 6.0e-7 JAX, 2.4e-7
    port), clipped gradients within 1e-6 (1.1e-7, 1.4e-7 of |g|max 0.24)."""
    images, labels, tf = _images(4, CLIP_PX, 3), np.array([0, 2, 1, 2], np.int32), _tf()
    jm = JTinyClassifier()

    def loss_fn(p):
        x = jclip_preprocess(jnp.asarray(images), CLIP_GRID)
        return JL.cross_entropy(jm.apply({"params": p}, x, jnp.asarray(tf)),
                                jnp.asarray(labels))

    loss, grads, new = _jax_step(jm, clip_vars(), "CLIP", loss_fn)
    model = port_clip()
    opt = S.build_optimizer(LR, WD, 1.0, set_trainable(model, finetune_filter("CLIP")))
    got, correct = clip_train_step(model, opt, torch.from_numpy(images),
                                   torch.from_numpy(labels), torch.from_numpy(tf), CLIP_GRID)
    _check_step(float(got), model, loss, clip_classifier_state_dict({"params": grads}),
                clip_classifier_state_dict({"params": new}), 1e-6, 2e-6)
    assert 0 <= int(correct) <= 4
    frozen = clip_classifier_state_dict(clip_vars())
    for key in ("visual_projection.weight", "logit_scale"):
        assert torch.equal(model.state_dict()[key], frozen[key])


@pytest.mark.parametrize("tail", [False, True], ids=["full", "padded_tail"])
def test_clipseg_step_matches_jax(tail):
    """One decoder step (20 -> 48 bicubic, masks 20 -> 24 bilinear, the
    combined loss; with `tail` a B=3 batch padded to 4 and the masked
    loss, as the JAX finetuner's tail step): loss within 1.1e-6 (float64
    distances: JAX 3.6e-7, port 0), clipped gradients within 3e-7 (JAX
    8.1e-8, port 1.5e-8, |g|max 0.059)."""
    images, masks, cond = _images(4, SEG_PX, 4), _masks(4, SEG_PX, 5), _cond()
    n = 3 if tail else 4
    if tail:
        images, masks = (np.concatenate([a[:3], a[2:3]]) for a in (images, masks))
    jm = JTinyCLIPSeg()
    logit = CLIPSEG_GRID // TV.patch_size * 4  # two k2/s2 transposed convs

    def loss_fn(p):
        x = jclip_preprocess(jnp.asarray(images), CLIPSEG_GRID)
        m = jnp.asarray(masks).astype(jnp.float32)[..., None] / 255.0
        m = jax.image.resize(m, (4, logit, logit, 1), method="bilinear")[..., 0]
        logits = jm.apply({"params": p}, x, cond=jnp.broadcast_to(jnp.asarray(cond), (4, PROJ)))
        if tail:
            return JL.masked_combined_loss(logits, m, JL.valid_mask(4, n))
        return JL.combined_loss(logits, m)

    loss, grads, new = _jax_step(jm, clipseg_vars(), "CLIPSeg", loss_fn)
    model = port_clipseg()
    assert model.logit_size(CLIPSEG_GRID) == logit
    opt = S.build_optimizer(LR, WD, 1.0, set_trainable(model, finetune_filter("CLIPSeg")))
    got = clipseg_train_step(model, opt, torch.from_numpy(images), torch.from_numpy(masks),
                             torch.from_numpy(cond), logit, CLIPSEG_GRID,
                             n_valid=n if tail else None)
    sd_grads = clipseg_state_dict({"params": grads})
    sd_new = clipseg_state_dict({"params": new})
    _check_step(float(got), model, loss, sd_grads, sd_new, 3e-7, 1.1e-6)


def test_masked_padded_tail_equals_ragged_step():
    """Port of tests/test_finetuners.py::test_masked_padded_tail_equals_ragged_step:
    a ragged B=3 batch padded to 4 (its last row repeated) under the masked
    combined loss gives the ragged batch's loss and decoder gradients."""
    images, masks, cond = _images(3, SEG_PX, 6), _masks(3, SEG_PX, 7), torch.from_numpy(_cond())
    model = port_clipseg()
    set_trainable(model, finetune_filter("CLIPSeg"))
    logit = model.logit_size(CLIPSEG_GRID)

    def loss_and_grads(imgs, msks, n_valid):
        x, m = clipseg_prep(torch.from_numpy(imgs), torch.from_numpy(msks), CLIPSEG_GRID, logit)
        logits = model(x, cond=cond.expand(x.shape[0], -1))
        loss = (L.combined_loss(logits, m) if n_valid is None else
                L.masked_combined_loss(logits, m, L.valid_mask(x.shape[0], n_valid)))
        model.zero_grad(set_to_none=True)
        loss.backward()
        return float(loss), {n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    l1, g1 = loss_and_grads(images, masks, None)
    padded = [t.numpy() for t in pad_rows(1, torch.from_numpy(images), torch.from_numpy(masks))]
    l2, g2 = loss_and_grads(*padded, 3)
    assert l1 == pytest.approx(l2, rel=1e-6)
    assert set(g1) == set(g2) and all(k.startswith("decoder.") for k in g1)
    for k in g1:
        torch.testing.assert_close(g1[k], g2[k], rtol=1e-5, atol=1e-7)


# --- 2-epoch runs -------------------------------------------------------------------

def _capture(module, monkeypatch):
    """Replace the JAX finetuner's save_best with a recorder of (epoch,
    params)."""
    saved = []
    monkeypatch.setattr(module.ckpt, "save_best",
                        lambda *a, meta, aux, **_: saved.append(
                            (meta["epoch"], jax.tree.map(np.asarray, a[3]), aux)))
    return saved


def _epochs(logs, tag):
    """Each epoch line's numbers, in order."""
    return [[float(v) for v in re.findall(r"-?\d+\.\d+", line)]
            for line in logs if line.startswith(f"[{tag}] Ep")]


def test_finetune_clip_matches_jax(tmp_path, monkeypatch):
    """2 epochs of both finetune_clip on 14 train (3 batches of 4 + a
    ragged 2) and 5 validation samples (4 + a ragged 1) at 40px: the same
    epoch lines (losses to 1e-3 as logged, accuracies equal), the same
    epochs saved, and the saved vision tower's update (final - initial)
    within 1e-2 of JAX's in relative L2 (2.1e-3 measured over 6 steps at
    lr 1e-3: AdamW's first moves are lr*sign(g), so gradients at float32
    noise move by up to 2*lr apart, while the one-step test holds every
    gradient to 1e-6); the projection, logit_scale and the aux text
    features exact."""
    jds, ds = jsynthetic_cls(n=19, img_size=CLIP_PX, seed=2), synthetic_cls(
        n=19, img_size=CLIP_PX, seed=2)
    tr_idx, va_idx = np.arange(14), np.arange(14, 19)
    cfg = dict(epochs=2, lr=LR)
    jlogs, tlogs = [], []
    saved = _capture(jclip_ft, monkeypatch)
    from medseg_tpu.core.config import CLIPFinetuneConfig as JCfg
    jbest = jclip_ft.finetune_clip(
        JBatchLoader(jds, 4, shuffle=True, seed=3, indices=tr_idx),
        JBatchLoader(jds, 4, shuffle=False, indices=va_idx), clip_vars(), _tf(),
        JCfg(save_root=str(tmp_path / "jax"), **cfg), model=JTinyClassifier(),
        image_size=CLIP_GRID, log=jlogs.append)
    model = port_clip()
    best = finetune_clip(
        BatchLoader(ds, 4, shuffle=True, seed=3, indices=tr_idx, device="cpu"),
        BatchLoader(ds, 4, shuffle=False, indices=va_idx, device="cpu"), model, _tf(),
        CLIPFinetuneConfig(save_root=str(tmp_path), **cfg),
        image_size=CLIP_GRID, log=tlogs.append, device="cpu")
    assert best == jbest
    jl, tl = _epochs(jlogs, "CLIP"), _epochs(tlogs, "CLIP")
    assert len(tl) == 2 and np.allclose(tl, jl, atol=1.01e-3), (tl, jl)
    assert [l for l in tlogs if l.startswith("Saved")] == [
        l for l in jlogs if l.startswith("Saved")]
    assert saved
    want = clip_classifier_state_dict({"params": saved[-1][1]})
    got, aux = ckpt.split_aux(torch.load(
        tmp_path / "classification_models" / "CLIP_best_acc.pt", weights_only=True))
    init = clip_classifier_state_dict(clip_vars())
    assert set(got) == set(want)
    num = sum(float((got[k] - want[k]).double().square().sum()) for k in got)
    den = sum(float((want[k] - init[k]).double().square().sum()) for k in got)
    assert den > 0 and (num / den) ** 0.5 <= 1e-2, (num / den) ** 0.5
    for k in ("visual_projection.weight", "logit_scale"):
        assert torch.equal(got[k], init[k])
    assert torch.equal(aux["text_features"], torch.from_numpy(_tf()))


def test_finetune_clipseg_matches_jax(tmp_path, monkeypatch):
    """2 epochs of both finetune_clipseg on 7 train samples (a batch of 4
    and a ragged 3: the padded masked step) and 5 validation ones (4 + a
    ragged 1, padded) at 20px: the same epoch lines (to 1e-3 as logged),
    the same saves, the saved decoder's update within 1e-3 of JAX's in
    relative L2 (1.1e-4 measured), the backbone exact, the aux cond
    exact."""
    jds, ds = jsynthetic_seg(n=12, img_size=SEG_PX, seed=4), synthetic_seg(
        n=12, img_size=SEG_PX, seed=4)
    tr_idx, va_idx = np.arange(7), np.arange(7, 12)
    cfg = dict(epochs=2, lr=LR)
    jlogs, tlogs = [], []
    saved = _capture(jclipseg_ft, monkeypatch)
    from medseg_tpu.core.config import CLIPSegFinetuneConfig as JCfg
    jbest = jclipseg_ft.finetune_clipseg(
        JBatchLoader(jds, 4, shuffle=True, seed=3, indices=tr_idx),
        JBatchLoader(jds, 4, shuffle=False, indices=va_idx), clipseg_vars(), _cond(),
        JCfg(save_root=str(tmp_path / "jax"), **cfg), model=JTinyCLIPSeg(),
        image_size=CLIPSEG_GRID, log=jlogs.append)
    model = port_clipseg()
    best = finetune_clipseg(
        BatchLoader(ds, 4, shuffle=True, seed=3, indices=tr_idx, device="cpu"),
        BatchLoader(ds, 4, shuffle=False, indices=va_idx, device="cpu"), model, _cond(),
        CLIPSegFinetuneConfig(save_root=str(tmp_path), **cfg),
        image_size=CLIPSEG_GRID, log=tlogs.append, device="cpu")
    assert best == pytest.approx(jbest, abs=1e-6)
    jl, tl = _epochs(jlogs, "CLIPSeg"), _epochs(tlogs, "CLIPSeg")
    assert len(tl) == 2 and np.allclose(tl, jl, atol=1.01e-3), (tl, jl)
    assert len([l for l in tlogs if l.startswith("Saved")]) == len(saved)
    want = clipseg_state_dict({"params": saved[-1][1]})
    got, aux = ckpt.split_aux(torch.load(
        tmp_path / "segmentation_models" / "CLIPSeg_best_loss.pt", weights_only=True))
    init = clipseg_state_dict(clipseg_vars())
    dec = [k for k in got if k.startswith("decoder.")]
    num = sum(float((got[k] - want[k]).double().square().sum()) for k in dec)
    den = sum(float((want[k] - init[k]).double().square().sum()) for k in dec)
    assert den > 0 and (num / den) ** 0.5 <= 1e-3, (num / den) ** 0.5
    assert all(torch.equal(got[k], init[k]) for k in got if k not in dec)
    assert torch.equal(aux["cond"], torch.from_numpy(_cond()))


# --- aux through eval and serving ---------------------------------------------------

@pytest.mark.parametrize("name", ["CLIP", "CLIPSeg"])
def test_finetuned_checkpoint_evaluates_and_serves(name, tmp_path):
    """save_best with aux -> load_model_bundle returns the aux tensor and a
    state dict that loads strictly -> evaluate_model and Pipeline run with
    $MEDSEG_PROMPT_IDS unset (the text features or cond come from the
    file), as the JAX harness reads aux first; the meta sidecar."""
    seg = name == "CLIPSeg"
    model, key, value = ((port_clipseg(), "cond", _cond()) if seg else
                         (port_clip(), "text_features", _tf()))
    sub = "segmentation_models" if seg else "classification_models"
    path = ckpt.save_best(str(tmp_path / sub), name, model, seg, meta={"epoch": 1},
                          aux={key: torch.from_numpy(value)})
    assert path.with_suffix(".meta.json").read_text() == '{"epoch": 1}'
    with tiny_clip_patched(tmp_path), pytest.MonkeyPatch.context() as mp:
        mp.delenv("MEDSEG_PROMPT_IDS")
        sd, extra = load_model_bundle(name, str(tmp_path), seg, device="cpu")
        assert list(extra) == [key] and torch.equal(extra[key], torch.from_numpy(value))
        assert not any(k.startswith(ckpt.AUX_PREFIX) for k in sd)
        ds = (synthetic_seg if seg else synthetic_cls)(n=5, img_size=CLIP_PX, seed=8)
        res = evaluate_model(name, BatchLoader(ds, 4, shuffle=False, device="cpu"),
                             cfg=EvalConfig(weights_root=str(tmp_path)),
                             log=lambda *_: None, device="cpu")
        assert (res["confusion_matrix"].sum() == 5) if not seg else 0 <= res["dice"] <= 100
        pipe = Pipeline(EvalConfig(weights_root=str(tmp_path)), device="cpu")
        img = _images(1, 50, 9)[0]
        if seg:
            pipe._load_models("ResNet18", name)  # a fresh-init classifier
            assert pipe._seg[1] is not None
            probs = pipe._forward(pipe._seg[1], Pipeline._grid_batch([img], CLIPSEG_GRID,
                                                                     pipe.device, "bicubic"))
            assert probs.shape[1:3] == (model.logit_size(CLIPSEG_GRID),) * 2
        else:
            pipe._load_models(name, "ResNetUnet")  # no ResNetUnet: the placeholder
            label, confidence, _, _ = pipe.process_image(img, "ResNetUnet")
            assert label in ("COVID", "Healthy", "Non-COVID") and 0 <= confidence <= 100


def test_split_train_val_matches_jax():
    for n, frac in ((60, 0.1111), (100, 0.2), (7, 0.5)):
        for a, b in zip(split_train_val(n, frac, 0), jsplit_train_val(n, frac, 0)):
            np.testing.assert_array_equal(a, b)
    tr, va = split_train_val(60, 0.1111)
    assert len(tr) == 53 and len(va) == 7  # the chip run's ragged CLIPSeg tail of 5


def test_full_float32_restores_flags():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with full_float32():
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
