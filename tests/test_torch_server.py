"""The port's HTTP inference server, batch predictor and CLI on the CPU
(device="cpu"), mirroring tests/test_server.py and
tests/test_batch_predict.py with ResNetUnet in place of AttentionUNet, at a
64px grid (IMG_SIZE patched); batch_predict is held against the JAX
package's on the same `.pt` files."""

import base64
import csv
import io
import json
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from medseg_tpu.infer import batch as jbatch
from medseg_tpu.infer import pipeline as jpipeline
from medseg_tpu_torch.apps import cli
from medseg_tpu_torch.core.config import EvalConfig
from medseg_tpu_torch.infer import batch as tbatch
from medseg_tpu_torch.infer import pipeline as tpipeline
from medseg_tpu_torch.infer.pipeline import Pipeline
from medseg_tpu_torch.infer.server import InferenceServer
from tests.torch_infer_helpers import GRID, images, write_weights, write_zoo_weights

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def grid64():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipeline, "IMG_SIZE", GRID)
        mp.setattr(jpipeline, "IMG_SIZE", GRID)
        yield


@pytest.fixture(scope="module")
def covid_root(tmp_path_factory):
    """ResNet18 with its head biased to COVID, and ResNetUnet: the whole
    cascade runs for every image."""
    return write_weights(tmp_path_factory.mktemp("weights"), winner=0)


def _server(root, **kw):
    return InferenceServer(EvalConfig(weights_root=str(root)), device="cpu", **kw)


def _post(port, payload: dict, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _png(img) -> bytes:
    Image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _b64png(img):
    return base64.b64encode(_png(img)).decode()


def _read(data: bytes):
    Image = pytest.importorskip("PIL.Image")
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def test_server_predict_roundtrip(covid_root):
    server = _server(covid_root)
    httpd, port = server.start_background()
    try:
        img = images(0, [(80, 72)])[0]
        out = _post(port, {"image": _b64png(img), "classification_model": "ResNet18",
                           "segmentation_model": "ResNetUnet"})
        assert out["prediction"] == "COVID" and 0 <= out["confidence"] <= 100
        assert "highlighted in red" in out["analysis"]
        overlay = _read(base64.b64decode(out["overlay"]))
        assert overlay.shape == img.shape
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok"
        assert health["models"] == {"classification": "ResNet18",
                                    "segmentation": "ResNetUnet"}
        assert health["batching"]["requests"] == 1
    finally:
        httpd.shutdown()


def test_server_bad_request_and_unknown_path():
    server = _server("/nonexistent")
    httpd, port = server.start_background()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=b"not json",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()


@pytest.mark.parametrize("field,name,item", [
    ("classification_model", "CLIP", "A.12"), ("segmentation_model", "CLIPSeg", "A.12")])
def test_server_pending_model_is_a_400(covid_root, tmp_path, field, name, item):
    """The models of ROADMAP `item`, once answered with a 400, are served:
    a request naming CLIP (in front of ResNetUnet) or CLIPSeg (behind the
    COVID-forced ResNet18), at the tiny tower config, gets a 200 and
    /health names the model; a CLIPSeg verdict comes with its overlay at
    the request's size."""
    from tests.torch_clip_helpers import tiny_clip_patched, write_clip_weights

    with tiny_clip_patched(tmp_path):
        server = _server(write_clip_weights(write_weights(tmp_path / "w", winner=0)))
        httpd, port = server.start_background()
        try:
            img = images(1, [(GRID, GRID + 8)])[0]
            out = _post(port, {"image": _b64png(img), field: name})
            assert out["prediction"] in ("COVID", "Healthy", "Non-COVID")
            assert item not in out["analysis"]
            if name == "CLIPSeg":
                assert out["prediction"] == "COVID"
                assert _read(base64.b64decode(out["overlay"])).shape == img.shape
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                        timeout=30) as resp:
                assert name in json.loads(resp.read())["models"].values()
        finally:
            httpd.shutdown()


@pytest.mark.parametrize("field,name", [("classification_model", "VGG16"),
                                        ("segmentation_model", "AttentionUNet")])
def test_server_serves_zoo_model(covid_root, tmp_path, field, name):
    """A request naming VGG16 (224 grid; fresh-initialized, as the JAX
    package falls back without its weights) or AttentionUNet (its own .pt,
    behind the COVID-forced ResNet18) is answered with a 200, and /health
    names the model."""
    root = write_weights(tmp_path, winner=0)
    if name == "AttentionUNet":
        write_zoo_weights(root, name)
    server = _server(root)
    httpd, port = server.start_background()
    try:
        img = images(2, [(80, 72)])[0]
        out = _post(port, {"image": _b64png(img), field: name})
        assert out["prediction"] in ("COVID", "Healthy", "Non-COVID")
        if name == "AttentionUNet":
            assert out["prediction"] == "COVID"
            assert _read(base64.b64decode(out["overlay"])).shape == img.shape
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as resp:
            models = json.loads(resp.read())["models"]
        assert name in models.values()
        entry = server.pipeline._cls if name == "VGG16" else server.pipeline._seg
        size = 224 if name == "VGG16" else GRID
        assert {tuple(s[1:3]) for s in entry[1].seen_batches} == {(size, size)}
    finally:
        httpd.shutdown()
        shutil.rmtree(root)  # ~0.2 GB


def test_server_warmup_covers_all_burst_shapes(covid_root):
    """After warmup both forwards have seen every power-of-two batch shape
    a group pads to, and a full MAX_BATCH burst adds none."""
    server = _server(covid_root)
    server.warmup(log=lambda *_: None)
    p = server.pipeline
    expected = {(b, GRID, GRID, 3) for b in (1, 2, 4, 8) if b <= Pipeline.MAX_BATCH}
    assert p._cls[1].seen_batches == expected
    assert p._seg[1].seen_batches == expected
    imgs = images(2, [(GRID + 16, GRID)] * Pipeline.MAX_BATCH)
    outs = p.process_batch(imgs, "ResNetUnet")
    assert [o[0] for o in outs] == ["COVID"] * Pipeline.MAX_BATCH
    assert p._cls[1].seen_batches == expected and p._seg[1].seen_batches == expected


def test_server_worker_survives_malformed_item_and_timeout(tmp_path):
    """The single worker outlives any exception, and a stalled forward is
    answered with a 503, after which the server still answers."""
    server = _server(tmp_path)
    bad = {"img": None, "event": threading.Event(), "result": None}  # no "key"
    server._queue.put(bad)
    assert bad["event"].wait(timeout=10)
    assert isinstance(bad["result"], Exception)
    assert server.stats["worker_errors"] == 1
    assert server._worker.is_alive()

    server.pipeline._load_models = lambda *a, **k: None
    server.pipeline.process_batch = (
        lambda imgs, *a, **k: (time.sleep(1.0), [("Healthy", 50.0, None, "ok")] * len(imgs))[1])
    server.REQUEST_TIMEOUT_S = 0.05
    httpd, port = server.start_background()
    try:
        payload = {"image": _b64png(np.zeros((8, 8, 3), np.uint8))}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, payload, timeout=30)
        assert ei.value.code == 503
        server.REQUEST_TIMEOUT_S = 30.0
        assert _post(port, payload, timeout=30)["prediction"] == "Healthy"
    finally:
        httpd.shutdown()


def test_server_micro_batching_concurrent(covid_root):
    """Concurrent requests within the window ride one forward
    (stats.max_batch >= 2) and each gets its own valid response."""
    server = _server(covid_root)
    server.BATCH_WINDOW_S = 0.5  # let the threads land together
    httpd, port = server.start_background()
    try:
        imgs = images(3, [(GRID, GRID)] * 4)
        outs = [None] * 4

        def post(i):
            outs[i] = _post(port, {"image": _b64png(imgs[i])}, timeout=600)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive()
        for img, out in zip(imgs, outs):
            assert out["prediction"] == "COVID"
            assert _read(base64.b64decode(out["overlay"])).shape == img.shape
        assert server.stats["requests"] == 4
        assert server.stats["max_batch"] >= 2, server.stats
    finally:
        httpd.shutdown()


def _image_dir(path):
    """Five PNGs at the grid and at twice the grid (an exact 2x resize)."""
    path.mkdir()
    for i, img in enumerate(images(4, [(GRID, GRID), (2 * GRID, 2 * GRID)] * 2
                                   + [(2 * GRID, 2 * GRID)])):
        (path / f"x{i}.png").write_bytes(_png(img))
    return sorted(str(p) for p in path.glob("*.png"))


def test_batch_predict_matches_jax(covid_root, tmp_path):
    """The same directory and .pt files through both packages'
    batch_predict (batches of 3 and 2): the same rows and overlay pixels,
    confidences within 1e-3 points, and a predictions.csv that reads back."""
    paths = _image_dir(tmp_path / "imgs")
    kw = dict(cls_name="ResNet18", seg_name="ResNetUnet", batch_size=3,
              log=lambda *_: None)
    got = tbatch.batch_predict(paths, cfg=EvalConfig(weights_root=str(covid_root)),
                               output_dir=str(tmp_path / "t"), device="cpu", **kw)
    want = jbatch.batch_predict(paths, cfg=jpipeline.EvalConfig(weights_root=str(covid_root)),
                                output_dir=str(tmp_path / "j"), **kw)
    assert [r["file"] for r in got] == [f"x{i}.png" for i in range(5)]
    for g, w in zip(got, want):
        assert (g["file"], g["prediction"]) == (w["file"], w["prediction"]) == (g["file"], "COVID")
        assert abs(g["confidence"] - w["confidence"]) <= 1e-3
        ours = _read(open(g["overlay_path"], "rb").read())
        theirs = _read(open(w["overlay_path"], "rb").read())
        np.testing.assert_array_equal(ours, theirs)
    with open(tmp_path / "t" / "predictions.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["file"] for r in rows] == [r["file"] for r in got]
    assert [float(r["confidence"]) for r in rows] == [r["confidence"] for r in got]
    assert all(r["overlay_path"].endswith("_overlay.png") for r in rows)


def test_batch_predict_missing_classifier_weights(tmp_path):
    with pytest.raises(FileNotFoundError):
        tbatch.batch_predict(["nope.png"], cfg=EvalConfig(weights_root=str(tmp_path)),
                             log=lambda *_: None, device="cpu")
    # CLIP, once refused (ROADMAP A.12), is missing its weights like any other
    with pytest.raises(FileNotFoundError, match="no weights for CLIP"):
        tbatch.batch_predict(["nope.png"], cls_name="CLIP", device="cpu",
                             cfg=EvalConfig(weights_root=str(tmp_path)))


def test_cli_predict_writes_the_csv(covid_root, tmp_path, capsys):
    """python -m medseg_tpu_torch.apps.cli predict, on the CPU."""
    _image_dir(tmp_path / "imgs")
    cli.main(["predict", "--input", str(tmp_path / "imgs"), "--output",
              str(tmp_path / "out"), "--weights-root", str(covid_root),
              "--device", "cpu", "--batch-size", "4"])
    with open(tmp_path / "out" / "predictions.csv") as f:
        assert len(list(csv.DictReader(f))) == 5
    assert len(list((tmp_path / "out").glob("*_overlay.png"))) == 5
    cli.main(["predict", "--input", str(tmp_path / "empty"), "--device", "cpu"])
    assert "no images found" in capsys.readouterr().out


def test_entry_points_raise_without_a_card(monkeypatch, covid_root):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EvalConfig(weights_root=str(covid_root))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.batch_predict(["x.png"], cfg=cfg)
