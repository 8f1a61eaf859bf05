"""The port's CLIP and CLIPSeg in the eval harness, the Pipeline, the server
and batch_predict, against the JAX package's on the CPU: both read the
same reference `.pt` files (flax-initialized tiny towers carried through
interop/from_jax) and the same prompt-ids bundle, with the tiny models and
their 32px (CLIP) and 48px (CLIPSeg) grids patched into both packages
(tests/torch_clip_helpers.py), beside the 64px CNN grid of
tests/test_torch_infer.py."""

import base64
import io
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.core.config import EvalConfig as JEvalConfig
from medseg_tpu.data.loader import BatchLoader as JLoader
from medseg_tpu.data.synthetic import synthetic_cls as jsynthetic_cls
from medseg_tpu.data.synthetic import synthetic_seg as jsynthetic_seg
from medseg_tpu.eval import harness as jharness
from medseg_tpu.infer import batch as jbatch
from medseg_tpu.infer import pipeline as jpipeline
from medseg_tpu_torch.core.config import EvalConfig
from medseg_tpu_torch.data.loader import BatchLoader
from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg
from medseg_tpu_torch.eval import harness as tharness
from medseg_tpu_torch.infer import batch as tbatch
from medseg_tpu_torch.infer import pipeline as tpipeline
from medseg_tpu_torch.infer.server import InferenceServer
from tests import torch_clip_helpers as H
from tests.test_torch_infer import _assert_same_verdicts
from tests.torch_infer_helpers import GRID, images, write_weights

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHAPES = [(80, 96), (300, 260), (GRID, GRID)]  # (H, W): each resized to 32 and 48


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny models and grids patched in, IMG_SIZE at GRID, and one
    weights root: COVID-forced ResNet18, ResNetUnet, CLIP and CLIPSeg."""
    base = tmp_path_factory.mktemp("clip_weights")
    with H.tiny_clip_patched(base), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipeline, "IMG_SIZE", GRID)
        mp.setattr(jpipeline, "IMG_SIZE", GRID)
        yield H.write_clip_weights(write_weights(base / "w", winner=0))


def _pipelines(root, cls_name, seg_name):
    cfg = dict(weights_root=str(root))
    tp = tpipeline.Pipeline(EvalConfig(**cfg), device="cpu")
    jp = jpipeline.Pipeline(jpipeline.EvalConfig(**cfg))
    for p in (tp, jp):
        p._load_models(cls_name, seg_name)
    return tp, jp


def _forwards(tp, jp, entry, arrays):
    """One entry's ("cls" or "seg") forward in both packages on each
    package's own grid of the same originals."""
    t_entry, j_entry = (tp._cls, jp._cls) if entry == "cls" else (tp._seg, jp._seg)
    size, method = tpipeline.Pipeline.input_grid(t_entry[0])
    assert jpipeline.Pipeline.input_grid(j_entry[0]) == (size, method)
    grid = jnp.concatenate([jp._to_grid(jnp.asarray(a[None]), size, method) for a in arrays])
    want = np.asarray(j_entry[2](jp._pad_pow2(grid)))[:len(arrays)]
    got = tp._forward(t_entry[1], tp._grid_batch(arrays, size, CPU, method))
    return got, want


@pytest.mark.parametrize("cls_name,seg_name", [("CLIP", "CLIPSeg"), ("ResNet18", "CLIPSeg"),
                                               ("CLIP", "ResNetUnet")])
def test_pipeline_with_a_clip_half_matches_jax(root, cls_name, seg_name, capsys):
    """Three originals of other sizes through both packages' Pipelines:
    logits within 1e-3*max(1, |logit|max), probabilities within 1e-3 (the
    same tolerances as the CNN pipeline's, tests/test_torch_infer.py),
    verdicts and overlays as _assert_same_verdicts; each forward saw its
    one padded batch shape on its grid."""
    tp, jp = _pipelines(root, cls_name, seg_name)
    log = capsys.readouterr().out
    assert log.count(f"Successfully loaded Classification Model: {cls_name}") == 2
    assert log.count(f"Successfully loaded Segmentation Model: {seg_name}") == 2
    arrays = images(7, SHAPES)
    got, want = tp.process_batch(arrays, seg_name), jp.process_batch(arrays, seg_name)
    t_logits, j_logits = _forwards(tp, jp, "cls", arrays)
    np.testing.assert_allclose(t_logits, j_logits, rtol=0,
                               atol=1e-3 * max(1.0, np.abs(j_logits).max()))
    t_probs, j_probs = (p[..., 0] for p in _forwards(tp, jp, "seg", arrays))
    assert t_probs.shape == j_probs.shape
    np.testing.assert_allclose(t_probs, j_probs, rtol=0, atol=1e-3)
    _assert_same_verdicts(got, want, t_probs, j_probs)
    size = tpipeline.Pipeline.input_grid(cls_name)[0]
    assert (4, size, size, 3) in tp._cls[1].seen_batches
    if cls_name == "ResNet18":
        assert [r[0] for r in got] == ["COVID"] * 3
        assert all(r[2].shape == a.shape for r, a in zip(got, arrays))


def test_pipeline_clip_without_weights(root, tmp_path, capsys):
    """No CLIP weights: a fresh init, then the JAX package's ValueError for
    want of text features (medseg_tpu/infer/pipeline.py:87-90; its own
    fresh init at the tiny config trips over its 512-wide dummy features
    first, so the text is held here); with features passed, the
    fresh-initialized CLIP serves."""
    cfg = EvalConfig(weights_root=str(tmp_path))
    with pytest.raises(ValueError) as e:
        tpipeline.Pipeline(cfg, device="cpu")._load_models("CLIP", "ResNetUnet")
    assert str(e.value) == ("CLIP needs text_features: none embedded in the checkpoint "
                            "and none passed to Pipeline(text_features=...)")
    tf = np.eye(3, H.PROJ, dtype=np.float32)
    tp = tpipeline.Pipeline(cfg, text_features=tf, device="cpu")
    tp._load_models("CLIP", "ResNetUnet")
    out = tp.process_batch(images(8, [(40, 40)]), "ResNetUnet")
    assert out[0][0] in ("COVID", "Healthy", "Non-COVID")
    log = capsys.readouterr().out
    assert log.count("Weights file not found. Using fresh-initialized weights only.") == 2
    assert "CRITICAL ERROR: Failed to load segmentation weights for ResNetUnet" in log


def test_eval_harness_clip_and_clipseg_match_jax(root, tmp_path):
    """test_all_models over a weights root holding only CLIP and CLIPSeg:
    the same two rows in both packages (the float bicubic resize to 32 and
    48, CLIPSeg's sigmoid and bilinear resize to the 64px mask grid).
    Classification metrics equal (no two top logits of the JAX model
    within 1e-4 on this split, checked); segmentation metrics within 0.05
    points (a pixel whose probability lies within float32 noise of 0.5 may
    threshold apart); the log lines the same in number and headings."""
    eval_root = tmp_path / "eval"
    for sub, name in (("classification_models", "CLIP_best_acc.pt"),
                      ("segmentation_models", "CLIPSeg_best_loss.pt")):
        (eval_root / sub).mkdir(parents=True)
        (eval_root / sub / name).symlink_to(root / sub / name)
    n, size, batch = 10, 64, 4
    tlogs, jlogs = [], []
    got = tharness.test_all_models(
        BatchLoader(synthetic_cls(n, size), batch, shuffle=False, device="cpu"),
        BatchLoader(synthetic_seg(n, size), batch, shuffle=False, device="cpu"),
        EvalConfig(weights_root=str(eval_root)), log=tlogs.append, device="cpu")
    want = jharness.test_all_models(
        JLoader(jsynthetic_cls(n, size), batch, shuffle=False),
        JLoader(jsynthetic_seg(n, size), batch, shuffle=False),
        JEvalConfig(weights_root=str(eval_root)), log=jlogs.append)
    assert set(got) == set(want) == {"CLIP", "CLIPSeg"}
    for k, v in want["CLIP"].items():
        np.testing.assert_array_equal(np.asarray(got["CLIP"][k]), np.asarray(v), err_msg=k)
    for k, v in want["CLIPSeg"].items():
        np.testing.assert_allclose(got["CLIPSeg"][k], v, rtol=0, atol=0.05, err_msg=k)
    assert len(tlogs) == len(jlogs)
    assert [line for line in tlogs if not any(c.isdigit() for c in line)] == \
           [line for line in jlogs if not any(c.isdigit() for c in line)]

    # the CLIP margin that makes the equal argmax meaningful
    from medseg_tpu.ops.clip_prep import clip_preprocess as jclip_preprocess

    bundle = jharness.load_model_bundle("CLIP", str(eval_root), False)
    x = jclip_preprocess(jnp.asarray(jsynthetic_cls(n, size).images), H.CLIP_GRID)
    logits = np.asarray(H.JTinyClassifier().apply(bundle[0], x, **bundle[1]))
    top2 = np.sort(logits, -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-4


def test_eval_clip_extra_inputs_override_the_checkpoint(root):
    """Caller-supplied text features replace the checkpoint's own: the
    predictions follow the features passed, as in the JAX package."""
    n, size = 6, 64
    tf = np.zeros((3, H.PROJ), np.float32)
    tf[:, 0] = [1.0, -1.0, 0.0]  # the class follows the sign of feature 0
    extra = {"text_features": tf}
    got = tharness.evaluate_model(
        "CLIP", BatchLoader(synthetic_cls(n, size), 3, shuffle=False, device="cpu"), None,
        EvalConfig(weights_root=str(root)), extra_inputs=extra, log=lambda *_: None,
        device="cpu")
    want = jharness.evaluate_model(
        "CLIP", JLoader(jsynthetic_cls(n, size), 3, shuffle=False), None,
        JEvalConfig(weights_root=str(root)), extra, log=lambda *_: None)
    np.testing.assert_array_equal(got["confusion_matrix"], want["confusion_matrix"])
    assert got["confusion_matrix"][:, 2].sum() == 0  # class 2 never wins


def test_server_with_clip_halves_matches_jax_pipeline(root):
    """An InferenceServer on the port's Pipeline answers a CLIP + CLIPSeg
    request, after warming that pair, with the JAX Pipeline's verdict on
    the decoded image; warmup leaves no new batch shape for the request."""
    server = InferenceServer(EvalConfig(weights_root=str(root)), device="cpu")
    server.warmup("CLIP", "CLIPSeg", log=lambda *_: None)
    seen = (set(server.pipeline._cls[1].seen_batches), set(server.pipeline._seg[1].seen_batches))
    assert {s[1] for s in seen[0]} == {H.CLIP_GRID} and {s[1] for s in seen[1]} == {H.CLIPSEG_GRID}
    httpd, port = server.start_background()
    try:
        from PIL import Image

        img = images(9, [(70, 90)])[0]
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        body = json.dumps({"image": base64.b64encode(buf.getvalue()).decode(),
                           "classification_model": "CLIP",
                           "segmentation_model": "CLIPSeg"}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
    finally:
        httpd.shutdown()
    jp = jpipeline.Pipeline(jpipeline.EvalConfig(weights_root=str(root)))
    jp._load_models("CLIP", "CLIPSeg")
    want = jp.process_image(img, "CLIPSeg")
    assert out["prediction"] == want[0] and abs(out["confidence"] - want[1]) <= 1e-3
    assert out["analysis"] == want[3]
    assert (set(server.pipeline._cls[1].seen_batches),
            set(server.pipeline._seg[1].seen_batches)) == seen


def test_batch_predict_clip_clipseg_matches_jax(root, tmp_path):
    """batch_predict with CLIP + CLIPSeg over five PNGs in batches of 4:
    the same rows as the JAX package's, confidences within 1e-3 points."""
    from medseg_tpu_torch.infer.batch import _write_png

    src = tmp_path / "imgs"
    src.mkdir()
    for i, img in enumerate(images(10, SHAPES + [(50, 60), (GRID, 80)])):
        _write_png(img, src / f"im{i}.png")
    paths = sorted(str(p) for p in src.glob("*.png"))
    kw = dict(cls_name="CLIP", seg_name="CLIPSeg", batch_size=4, log=lambda *_: None)
    got = tbatch.batch_predict(paths, cfg=EvalConfig(weights_root=str(root)),
                               output_dir=str(tmp_path / "t"), device="cpu", **kw)
    want = jbatch.batch_predict(paths, cfg=JEvalConfig(weights_root=str(root)),
                                output_dir=str(tmp_path / "j"), **kw)
    assert [(g["file"], g["prediction"]) for g in got] == \
           [(w["file"], w["prediction"]) for w in want]
    for g, w in zip(got, want):
        assert abs(g["confidence"] - w["confidence"]) <= 1e-3
        assert (g["overlay_path"] is None) == (w["overlay_path"] is None)


def test_cli_predict_with_clip_takes_prompt_ids(root, tmp_path, monkeypatch):
    """`predict --cls-model CLIP --seg-model CLIPSeg --prompt-ids PATH`
    resolves the prompt ids from PATH ($MEDSEG_PROMPT_IDS) and writes one
    CSV row and one overlay per image (CLIP's verdicts here: whatever the
    tiny random towers say)."""
    import csv
    import os

    from medseg_tpu_torch.apps import cli
    from medseg_tpu_torch.infer.batch import _write_png

    ids = H.write_prompt_ids(tmp_path / "ids.json")
    monkeypatch.delenv("MEDSEG_PROMPT_IDS")
    src = tmp_path / "imgs"
    src.mkdir()
    for i, img in enumerate(images(11, [(70, 90), (GRID, GRID)])):
        _write_png(img, src / f"x{i}.png")
    cli.main(["predict", "--input", str(src), "--output", str(tmp_path / "out"),
              "--weights-root", str(root), "--device", "cpu", "--cls-model", "CLIP",
              "--seg-model", "CLIPSeg", "--prompt-ids", str(ids)])
    assert os.environ["MEDSEG_PROMPT_IDS"] == str(ids)
    with open(tmp_path / "out" / "predictions.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["file"] for r in rows] == ["x0.png", "x1.png"]
    covid = [r for r in rows if r["prediction"] == "COVID"]
    assert len(list((tmp_path / "out").glob("*_overlay.png"))) == len(covid)
