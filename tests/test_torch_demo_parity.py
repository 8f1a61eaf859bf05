"""The port's parity report, `eval --compare`, `parity`, `train --profile`,
StepTimer and the demo (ROADMAP A.15 part 2) against the JAX package:
compare_results_csv's dict and format_parity_report's lines on CSVs the
tests write, the `parity` command's exit codes, a torch.profiler trace from
`train --profile` on the CPU, the demo's CSS, page and handlers, and the
builtin demo served live on the CPU over loopback.
"""

import base64
import importlib.util
import io
import json
import shutil
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import medseg_tpu.apps.demo as jdemo
import medseg_tpu.eval.parity as jparity
import medseg_tpu.utils.profiling as jprofiling
from medseg_tpu_torch.apps import cli, demo
from medseg_tpu_torch.core.config import EvalConfig
from medseg_tpu_torch.data.packed import save_packed
from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg
from medseg_tpu_torch.eval import parity
from medseg_tpu_torch.infer.pipeline import Pipeline
from medseg_tpu_torch.infer.server import InferenceServer
from medseg_tpu_torch.models.resnet import resnet18
from medseg_tpu_torch.utils import profiling

CLS_HEADER = "Model,accuracy,precision,recall,f1"
# 17-digit values, as csv_io writes them: pandas' parser reads many of them
# one ulp from float()
CLS_ROWS = {"ResNet18": "92.66666666666667,93.06397306397307,92.66666666666666,"
                        "92.61544011544012",
            "VGG16": "88.33333333333333,88.7037037037037,88.33333333333334,"
                     "88.29365079365078",
            "CLIP": "71.0,70.12345678901235,71.0,70.55"}


def _write(path: Path, header: str, rows: dict):
    path.write_text("\n".join([header] + [f"{m},{v}" for m, v in rows.items()]) + "\n")
    return str(path)


def _drift(rows: dict, model: str, col: int, delta: float) -> dict:
    out = dict(rows)
    cells = out[model].split(",")
    cells[col] = repr(float(cells[col]) + delta)
    out[model] = ",".join(cells)
    return out


def _case(name: str, tmp_path: Path):
    """(ours, reference) CSV paths for one parity case."""
    ref = _write(tmp_path / "ref.csv", CLS_HEADER, CLS_ROWS)
    rows, header = dict(CLS_ROWS), CLS_HEADER
    if name == "drift":
        rows = _drift(_drift(rows, "VGG16", 1, 0.7), "CLIP", 3, -0.25)
    elif name == "missing_model":
        del rows["VGG16"]
    elif name == "extra_model":
        rows["ResNet50"] = "90.0,90.5,90.25,90.125"
    elif name == "column_one_side_lacks":
        header = "Model,accuracy,recall,f1,auc"
        rows = {m: ",".join([v.split(",")[0]] + v.split(",")[2:] + ["0.5"])
                for m, v in rows.items()}
    elif name == "empty_cell":
        rows["CLIP"] = "71.0,,71.0,70.55"
    return _write(tmp_path / "ours.csv", header, rows), ref


CASES = ["exact", "drift", "missing_model", "extra_model", "column_one_side_lacks",
         "empty_cell"]


def _same(a, b) -> bool:
    """Equal, with NaN equal to NaN (an empty cell)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b)
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tolerance", [0.5, 0.1])
def test_compare_results_csv_and_report_equal_jax(case, tolerance, tmp_path):
    ours, ref = _case(case, tmp_path)
    report = parity.compare_results_csv(ours, ref, tolerance=tolerance)
    want = jparity.compare_results_csv(ours, ref, tolerance=tolerance)
    assert _same(report, want), (report, want)
    lines, jlines = [], []
    parity.format_parity_report(report, log=lines.append)
    jparity.format_parity_report(want, log=jlines.append)
    assert lines == jlines
    assert report["within_tolerance"] == (case not in ("drift", "missing_model"))


def test_xstrtod_is_pandas_parser():
    """Hundreds of 6000 random 17-digit reprs parse one ulp off float()
    in pandas; the port's reader lands on pandas' value for every one."""
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    values = np.concatenate([rng.random(4000) * 100, rng.random(1000) * 1e-6,
                             -rng.random(1000) * 1e5])
    cells = [repr(float(v)) for v in values] + ["93", "1e5", "1.5E-3", " 7.25",
                                                "100.000000000000000001"]
    frame = pd.read_csv(io.StringIO("a\n" + "\n".join(cells) + "\n"))
    got = [parity._xstrtod(c) for c in cells]
    assert got == frame["a"].tolist()
    assert sum(g != float(c) for g, c in zip(got, cells)) > 100
    assert parity._xstrtod("1.5e") is None and parity._xstrtod("abc") is None


# -- eval --compare and parity through the CLI --------------------------------

@pytest.fixture
def eval_setup(tmp_path):
    """Tiny 32px test caches, a random ResNet18 .pt, a PNG-free root with
    a test split, and CPU paths for the CLI."""
    packed = tmp_path / "packed"
    save_packed(synthetic_cls(n=12, img_size=32, seed=2), str(packed), "test_cls")
    save_packed(synthetic_seg(n=4, img_size=32, seed=3), str(packed), "test_seg")
    weights = tmp_path / "w" / "classification_models"
    weights.mkdir(parents=True)
    torch.save(resnet18(device="cpu").state_dict(), weights / "ResNet18_best_acc.pt")
    (tmp_path / "dataset" / "splits").mkdir(parents=True)
    (tmp_path / "dataset" / "splits" / "test.csv").write_text("id,class\n")
    return tmp_path, ["--root", str(tmp_path / "dataset"), "--cache-dir", str(packed),
                      "--weights-root", str(tmp_path / "w"), "--device", "cpu"]


def test_eval_compare_prints_the_jax_report(eval_setup, capsys):
    tmp_path, common = eval_setup
    cli.main(["eval", "--results-dir", str(tmp_path / "r")] + common)
    produced = tmp_path / "r" / "classification_test_results.csv"
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    shutil.copy(produced, ref_dir / produced.name)
    capsys.readouterr()
    cli.main(["eval", "--results-dir", str(tmp_path / "r2"), "--compare", str(ref_dir)]
             + common)
    out = capsys.readouterr().out
    head = f"\n=== Parity vs {ref_dir / produced.name} ===\n"
    assert head in out and "segmentation_test_results.csv" not in out.split(head)[1]
    lines = []
    jparity.format_parity_report(jparity.compare_results_csv(
        str(tmp_path / "r2" / produced.name), str(ref_dir / produced.name)),
        log=lines.append)
    assert out.split(head)[1].splitlines() == lines
    assert lines[-1] == "max |delta| = 0.000 pp; within tolerance: True"


def test_parity_exit_codes(eval_setup, capsys):
    """0 on a reference equal to the produced CSV, 1 when a metric moved by
    1 pp, 2 when there is nothing to compare."""
    tmp_path, common = eval_setup
    cli.main(["eval", "--results-dir", str(tmp_path / "r")] + common)
    produced = tmp_path / "r" / "classification_test_results.csv"
    ref = tmp_path / "ref"
    ref.mkdir()
    shutil.copy(produced, ref / produced.name)
    capsys.readouterr()
    cli.main(["parity", "--reference", str(ref), "--results-dir", str(tmp_path / "p")]
             + common)
    out = capsys.readouterr().out
    assert "(tolerance 0.5 pp) ===" in out and out.rstrip().endswith("PARITY PASS")

    header, row = produced.read_text().splitlines()
    cells = row.split(",")
    cells[1] = repr(float(cells[1]) + 1.0)
    (ref / produced.name).write_text(f"{header}\n{','.join(cells)}\n")
    with pytest.raises(SystemExit) as e:
        cli.main(["parity", "--reference", str(ref), "--results-dir",
                  str(tmp_path / "p")] + common)
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "within tolerance: False" in out and out.rstrip().endswith("PARITY FAIL")

    with pytest.raises(SystemExit) as e:
        cli.main(["parity", "--reference", str(tmp_path / "none"), "--results-dir",
                  str(tmp_path / "p")] + common)
    assert e.value.code == 2
    assert "[ERROR] nothing to compare: no produced/reference CSV pairs" in \
        capsys.readouterr().out


# -- profiling ----------------------------------------------------------------

def test_train_profile_writes_a_trace(tmp_path, capsys):
    packed = tmp_path / "packed"
    save_packed(synthetic_cls(n=12, img_size=32, seed=0), str(packed), "train_cls")
    cli.main(["train", "ResNet18", "--epochs", "1", "--cache-dir", str(packed),
              "--weights-root", str(tmp_path / "w"), "--device", "cpu", "--profile",
              str(tmp_path / "trace")])
    assert "[ResNet18] Ep1:" in capsys.readouterr().out
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::convolution" in names or "aten::conv2d" in names
    assert not any(e.get("cat") == "kernel" for e in events)  # no card, no kernels


def test_trace_context_asks_for_cuda_only_on_the_card(monkeypatch, tmp_path):
    seen = []

    class Recorder:
        def __init__(self, activities, on_trace_ready):
            seen.append(sorted(a.name for a in activities))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Recorder)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for device in ("cpu", None, "cuda"):
        with profiling.trace_context(str(tmp_path), device):
            pass
    with profiling.trace_context(None):
        pass
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with profiling.trace_context(str(tmp_path)):
        pass
    assert seen == [["CPU"], ["CPU", "CUDA"], ["CPU", "CUDA"], ["CPU"]]


def test_step_timer_equals_jax(monkeypatch):
    # 5 steps of each timer in turn (enter, exit): both time each step as d
    steps = [0.5, 0.25, 2.0, 0.03125, 1.0]
    ticks = iter(np.cumsum([x for d in steps for x in (0.1, d, 0.1, d)]).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    timers = (profiling.StepTimer(warmup=1), jprofiling.StepTimer(warmup=1))
    assert timers[0].summary(8) == timers[1].summary(8) == "no steady-state samples"
    for _ in range(5):
        for t in timers:
            with t:
                pass
    a, b = timers
    assert a.times == b.times and a.steady == b.steady and a.mean() == b.mean()
    assert a.summary(16) == b.summary(16)


# -- demo ---------------------------------------------------------------------

def test_css_and_page_are_the_jax_packages():
    assert demo.CSS == jdemo.CSS
    assert (Path(demo.__file__).with_name("design.css").read_bytes()
            == Path(jdemo.__file__).with_name("design.css").read_bytes())
    assert demo.builtin_demo_page() == jdemo.builtin_demo_page()
    assert (demo.CLS_CHOICES, demo.SEG_CHOICES, demo.CONF_HIGH, demo.CONF_MED) == \
        (jdemo.CLS_CHOICES, jdemo.SEG_CHOICES, jdemo.CONF_HIGH, jdemo.CONF_MED)


class _FakeGr:
    @staticmethod
    def update(**kw):
        return dict(kw)


class _ScriptedPipeline:
    def __init__(self, result):
        self.result = result
        self.loaded = []

    def _load_models(self, cls_name, seg_name):
        self.loaded.append((cls_name, seg_name))

    def process_image(self, image, seg_name, overlay_opacity=0.5):
        return self.result


@pytest.mark.parametrize("result", [
    ("COVID", 95.0, np.zeros((4, 4, 3), np.uint8), "covid text"),
    ("COVID", 80.0, np.ones((4, 4, 3), np.uint8), "covid text"),
    ("COVID", 50.0, None, "no overlay"),
    ("Healthy", 99.0, None, "advice")], ids=["95", "80", "50", "healthy"])
def test_make_handlers_equal_jax(result):
    outs = []
    for module in (demo, jdemo):
        pipe = _ScriptedPipeline(result)
        handle, clear_all = module.make_handlers(pipe, _FakeGr)
        outs.append((handle("img", "VGG16", "R2Unet", 0.3), clear_all(), pipe.loaded))
    (ours, clear, loaded), (want, jclear, jloaded) = outs
    assert ours[0] == want[0] and ours[1] == want[1] and ours[3] == want[3]
    assert ours[2]["visible"] == want[2]["visible"]
    assert ours[2]["value"] is want[2]["value"] is result[2]
    assert clear == jclear and loaded == jloaded == [("VGG16", "R2Unet")]


def _png_b64(seed: int, h: int, w: int) -> str:
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
                    ).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_builtin_demo_serves_live_on_the_cpu(tmp_path, capsys):
    """The page and stylesheet mounted on an InferenceServer on the CPU
    (fresh-initialized ResNet18, no ResNetUnet weights), answered over
    loopback, and a /predict with a class and a confidence."""
    server = InferenceServer(EvalConfig(weights_root=str(tmp_path)), device="cpu")
    demo.attach_builtin_ui(server)
    demo.warmup_pipeline(server.pipeline)
    assert "[demo] warmup (ResNet18+ResNetUnet) " in capsys.readouterr().out
    httpd, port = server.start_background()
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            assert r.headers["Content-Type"] == "text/html; charset=utf-8"
            assert r.read() == jdemo.builtin_demo_page().encode()
        with urllib.request.urlopen(base + "/design.css", timeout=60) as r:
            assert r.headers["Content-Type"] == "text/css"
            assert r.read() == jdemo.CSS.encode()
        body = json.dumps({"image": _png_b64(0, 64, 80), "overlay_opacity": 0.4}).encode()
        req = urllib.request.Request(base + "/predict", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["prediction"] in ("COVID", "Healthy", "Non-COVID")
        assert 0.0 < out["confidence"] <= 100.0 and out["overlay"] is None
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_demo_cli_routes(monkeypatch, tmp_path, capsys):
    """`demo --builtin` mounts the page on an InferenceServer and serves it
    at --host/--port; without gradio, plain `demo` takes the same builtin
    route with the JAX package's fallback line."""
    served = []
    monkeypatch.setattr(InferenceServer, "serve",
                        lambda self, host, port: served.append((host, port, self)))
    common = ["--weights-root", str(tmp_path), "--device", "cpu", "--no-warmup"]
    cli.main(["demo", "--builtin", "--port", "7999"] + common)
    host, port, server = served[-1]
    assert (host, port) == ("127.0.0.1", 7999)
    assert set(server.ui_routes) == {"/", "/design.css"}
    assert server.pipeline.device.type == "cpu"
    if importlib.util.find_spec("gradio") is None:
        cli.main(["demo", "--host", "0.0.0.0"] + common)
        assert served[-1][:2] == ("0.0.0.0", 7860)
        assert ("[demo] No module named 'gradio'; falling back to the builtin web UI "
                "(same surface, stdlib HTTP)") in capsys.readouterr().out
    assert isinstance(server.pipeline, Pipeline)
