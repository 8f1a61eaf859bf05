"""The port's inference slice against the JAX package's, on the CPU: the
bilinear resize and `_to_grid`, the overlay, and `Pipeline.process_batch`
on the same `.pt` files at a 64px grid (IMG_SIZE patched in both pipeline
modules) through both branches of the COVID gate, with missing and pending
models, and the rest of the CNN zoo loading and serving on its grid."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.infer import overlay as joverlay
from medseg_tpu.infer import pipeline as jpipeline
from medseg_tpu.ops.image import resize_bilinear as jresize
from medseg_tpu_torch.core.config import EvalConfig
from medseg_tpu_torch.infer import overlay as toverlay
from medseg_tpu_torch.infer import pipeline as tpipeline
from medseg_tpu_torch.ops.image import resize_bilinear
from tests.torch_infer_helpers import GRID, images, write_weights, write_zoo_weights

torch.set_num_threads(1)

CPU = torch.device("cpu")
# original sizes (H, W) of the pipeline's images: at the grid, 2x the grid
# (weights 0.5/0.5, exact), and a general downscale
PIPE_SHAPES = [(GRID, GRID), (2 * GRID, 2 * GRID), (80, 96)]


# --- resize and _to_grid -------------------------------------------------------

@pytest.mark.parametrize("shape", [(299, 299, 256, 256), (384, 512, 256, 256),
                                   (80, 96, 64, 64), (37, 53, 64, 64), (3, 5, 7, 2)])
def test_resize_bilinear_matches_jax(shape):
    """float32 and uint8 inputs, down and up: max abs <= 1e-4 (the sums may
    round differently in the last bit; 1.5e-5 at 255 scale here)."""
    h, w, oh, ow = shape
    rng = np.random.default_rng(h * w)
    for x in (rng.normal(0, 50, (2, h, w, 3)).astype(np.float32),
              rng.integers(0, 256, (2, h, w, 3), np.uint8)):
        got = resize_bilinear(torch.from_numpy(x), oh, ow)
        want = np.asarray(jresize(jnp.asarray(x), oh, ow))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # NHW (no channel axis) and the identity size
    x = rng.normal(0, 1, (2, h, w)).astype(np.float32)
    np.testing.assert_allclose(resize_bilinear(torch.from_numpy(x), oh, ow).numpy(),
                               np.asarray(jresize(jnp.asarray(x), oh, ow)), atol=1e-4)
    assert torch.equal(resize_bilinear(torch.from_numpy(x), h, w), torch.from_numpy(x))


@pytest.mark.parametrize("shape", [(299, 299), (512, 512), (384, 512), (1024, 1024),
                                   (80, 96), (37, 53)])
def test_to_grid_matches_jax(shape):
    """uint8 -> uint8 at the 256 grid (64 for the small ones): equal except
    +-1 level on at most 0.1% of values (a sum rounding across a .5 tie),
    exact at 512 -> 256 (weights 0.5/0.5, exact sums)."""
    size = 256 if shape[0] >= 256 else 64
    batch = np.stack(images(shape[0], [shape]))
    got = tpipeline.Pipeline._to_grid(batch, size, CPU).numpy().astype(int)
    want = np.asarray(jpipeline.Pipeline._to_grid(jnp.asarray(batch), size,
                                                  "bilinear")).astype(int)
    assert got.shape == want.shape == (1, size, size, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, ((diff > 0).mean(), diff.max())
    if shape == (512, 512):
        assert diff.max() == 0


def test_to_grid_at_grid_size_is_the_copy():
    batch = np.stack(images(0, [(GRID, GRID)] * 2))
    got = tpipeline.Pipeline._to_grid(batch, GRID, CPU)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), batch)


# --- overlay ----------------------------------------------------------------

@pytest.mark.parametrize("sizes", [((64, 64), (64, 64)), ((64, 64), (299, 299)),
                                   ((256, 256), (80, 96)), ((32, 48), (100, 30))])
def test_resize_mask_nearest_and_red_overlay_match_jax(sizes):
    (mh, mw), (h, w) = sizes
    rng = np.random.default_rng(mh * w)
    mask = (rng.random((mh, mw)) > 0.5).astype(np.uint8) * 255
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    np.testing.assert_array_equal(toverlay.resize_mask_nearest(mask, h, w),
                                  joverlay.resize_mask_nearest(mask, h, w))
    for opacity in (0.5, 0.3, 1.0):
        np.testing.assert_array_equal(toverlay.red_overlay(img, mask, opacity),
                                      joverlay.red_overlay(img, mask, opacity))


# --- Pipeline against the JAX Pipeline ----------------------------------------

@pytest.fixture(scope="module")
def grid64():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipeline, "IMG_SIZE", GRID)
        mp.setattr(jpipeline, "IMG_SIZE", GRID)
        yield


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("weights")
    return {"covid": write_weights(base / "covid", winner=0),
            "healthy": write_weights(base / "healthy", winner=1),
            "no_cls": write_weights(base / "no_cls", cls=False),
            "no_seg": write_weights(base / "no_seg", winner=0, seg=False)}


def _pipelines(root):
    cfg = dict(weights_root=str(root))
    tp = tpipeline.Pipeline(EvalConfig(**cfg), device="cpu")
    jp = jpipeline.Pipeline(jpipeline.EvalConfig(**cfg))
    for p in (tp, jp):
        p._load_models("ResNet18", "ResNetUnet")
    return tp, jp


def _jax_forward(jp, entry, arrays):
    grid = jnp.concatenate([jp._to_grid(jnp.asarray(a[None]), GRID, "bilinear")
                            for a in arrays])
    return np.asarray(entry[2](jp._pad_pow2(grid)))[:len(arrays)]


def _assert_same_verdicts(got, want, t_probs=None, j_probs=None):
    """Class and text equal, confidence within 1e-3 points; overlays equal
    wherever the masks agree, and every differing mask pixel's JAX
    probability within 1e-3 of the threshold."""
    for j, ((tp_, tc, to, ta), (jp_, jc, jo, ja)) in enumerate(zip(got, want)):
        assert (tp_, ta) == (jp_, ja)
        assert abs(tc - jc) <= 1e-3
        assert (to is None) == (jo is None)
        if to is None:
            continue
        assert to.shape == jo.shape and to.dtype == np.uint8
        differ = np.any(to != np.asarray(jo), axis=-1)
        if differ.any():
            h, w = to.shape[:2]
            near = np.abs(toverlay.resize_mask_nearest(j_probs[j], h, w) - 0.5) <= 1e-3
            assert near[differ].all()


@pytest.mark.parametrize("head", ["covid", "healthy"])
def test_pipeline_process_batch_matches_jax(grid64, roots, head, capsys):
    """A group of [array, None, array, PIL image]: three real images padded
    to four.  Logits within 1e-3*max(1, |logit|max), COVID probabilities
    within 1e-3, verdicts and overlays as _assert_same_verdicts; the
    Healthy head runs no segmentation forward."""
    Image = pytest.importorskip("PIL.Image")
    tp, jp = _pipelines(roots[head])
    arrays = images(3, PIPE_SHAPES)
    batch = [arrays[0], None, arrays[1], Image.fromarray(arrays[2])]  # a PIL entry too
    got = tp.process_batch(batch, "ResNetUnet")
    want = jp.process_batch(batch, "ResNetUnet")
    assert got[1] == want[1] == ("No Image Uploaded", 0.0, None,
                                 "Please upload an image to begin analysis.")

    t_logits = tp._forward(tp._cls[1], tp._grid_batch(arrays, GRID, CPU))
    j_logits = _jax_forward(jp, jp._cls, arrays)
    tol = 1e-3 * max(1.0, np.abs(j_logits).max())
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=tol)
    assert tp._cls[1].seen_batches == {(4, GRID, GRID, 3)}
    if head == "covid":
        assert [r[0] for r in got] == ["COVID", "No Image Uploaded", "COVID", "COVID"]
        assert tp._seg[1].seen_batches == {(4, GRID, GRID, 3)}
        t_probs = tp._forward(tp._seg[1], tp._grid_batch(arrays, GRID, CPU))[..., 0]
        j_probs = _jax_forward(jp, jp._seg, arrays)[..., 0]
        np.testing.assert_allclose(t_probs, j_probs, rtol=0, atol=1e-3)
        _assert_same_verdicts(got, want, t_probs, j_probs)
    else:
        assert [r[0] for r in got] == ["Healthy", "No Image Uploaded", "Healthy", "Healthy"]
        assert tp._seg[1].seen_batches == set()  # the gate held
        _assert_same_verdicts(got, want)
    log = capsys.readouterr().out
    assert log.count("Successfully loaded Classification Model: ResNet18") == 2


def test_pipeline_missing_classifier_weights_fresh_init(grid64, roots, capsys):
    """Both packages log the fresh init (their draws differ, so only the
    text is compared); the port's fresh init is the same on every device."""
    tpipeline.Pipeline(EvalConfig(weights_root=str(roots["no_cls"])),
                       device="cpu")._load_models("ResNet18", "ResNetUnet")
    t_log = capsys.readouterr().out
    jpipeline.Pipeline(jpipeline.EvalConfig(weights_root=str(roots["no_cls"])))._load_models(
        "ResNet18", "ResNetUnet")
    j_log = capsys.readouterr().out
    assert t_log == j_log
    assert "Weights file not found. Using fresh-initialized weights only." in t_log
    a = tpipeline.build_model("ResNet18", None, CPU).state_dict()
    b = tpipeline.build_model("ResNet18", None, CPU).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_pipeline_missing_segmentation_weights_warns(grid64, roots, capsys):
    """The placeholder: both log the failed load and give a COVID verdict
    with the WARNING text and no overlay."""
    tp, jp = _pipelines(roots["no_seg"])
    log = capsys.readouterr().out
    assert log.count("CRITICAL ERROR: Failed to load segmentation weights for "
                     "ResNetUnet. Error: ResNetUnet") == 2
    img = images(4, [(GRID, GRID)])[0]
    got, want = tp.process_image(img, "ResNetUnet"), jp.process_image(img, "ResNetUnet")
    assert got[0] == "COVID" and got[2] is None
    assert "WARNING: Segmentation model failed to load." in got[3]
    _assert_same_verdicts([got], [want])


@pytest.mark.parametrize("name,seg,item", [("CLIP", False, "A.12"),
                                           ("CLIPSeg", True, "A.12")])
def test_pending_model_raises_not_implemented(roots, tmp_path, capsys, name, seg, item):
    """The models of ROADMAP `item`, once refused with NotImplementedError,
    now load and serve: CLIP (bicubic 32 grid at the tiny tower config)
    in front of ResNetUnet, CLIPSeg (bicubic 48) behind the
    COVID-forced ResNet18, each from its own .pt and prompt ids; no log
    line names the item.  Parity with the JAX package:
    tests/test_torch_clip_infer.py."""
    from tests.torch_clip_helpers import (CLIP_GRID, CLIPSEG_GRID, tiny_clip_patched,
                                          write_clip_weights)

    with tiny_clip_patched(tmp_path):
        root = write_clip_weights(write_weights(tmp_path / "w", winner=0))
        p = tpipeline.Pipeline(EvalConfig(weights_root=str(root)), device="cpu")
        names = ("ResNet18", name) if seg else (name, "ResNetUnet")
        p._load_models(*names)
        assert tpipeline.Pipeline.input_grid(name) == (
            CLIPSEG_GRID if seg else CLIP_GRID, "bicubic")
        arrays = images(6, [(80, 96), (GRID, GRID)])
        out = p.process_batch(arrays, names[1])
    log = capsys.readouterr().out
    assert f"Successfully loaded {'Segmentation' if seg else 'Classification'} Model: " \
           f"{name}" in log and item not in log
    assert p._seg[1] is not None and len(out) == 2
    if seg:
        assert [o[0] for o in out] == ["COVID", "COVID"]
        assert p._seg[1].seen_batches == {(2, CLIPSEG_GRID, CLIPSEG_GRID, 3)}
        assert all(o[2].shape == a.shape for o, a in zip(out, arrays))
    else:
        assert p._cls[1].seen_batches == {(2, CLIP_GRID, CLIP_GRID, 3)}


@pytest.mark.parametrize("name,seg", [("VGG16", False), ("VGG19", False),
                                      ("AttentionUNet", True), ("R2Unet", True),
                                      ("R2AttUnet", True)])
def test_zoo_model_is_served(grid64, roots, tmp_path, name, seg):
    """Each model of the rest of the CNN zoo loads and serves: VGG on its
    224 grid (from the missing-weights fresh init, as the JAX package
    falls back), each U-Net on the 256 grid (GRID here) from its own .pt
    behind the COVID-forced ResNet18, whose overlay then comes back at the
    image's size."""
    size = 224 if name.startswith("VGG") else GRID
    assert tpipeline.Pipeline.input_grid(name) == (size, "bilinear")
    root = write_weights(tmp_path, winner=0, seg=False)
    if seg:
        write_zoo_weights(root, name)
    p = tpipeline.Pipeline(EvalConfig(weights_root=str(root)), device="cpu")
    names = ("ResNet18", name) if seg else (name, "ResNetUnet")
    p._load_models(*names)
    shutil.rmtree(root)  # ~0.2 GB a case, loaded by now
    entry = p._seg if seg else p._cls
    assert type(entry[1].model).__name__ == {
        "VGG": "VGGClassifier", "Att": "AttentionUNet", "R2U": "R2UNet",
        "R2A": "R2UNet"}[name[:3]]
    img = images(20, [(80, 96)])[0]
    prediction, _, overlay, analysis = p.process_image(img, names[1])
    assert {tuple(s[1:3]) for s in entry[1].seen_batches} == {(size, size)}
    if seg:
        assert prediction == "COVID" and overlay.shape == img.shape
        assert "highlighted in red" in analysis
    else:
        assert prediction in ("COVID", "Healthy", "Non-COVID")
