"""The port's eval harness and CSV export against the JAX package's, on the
same data, the same weights and the same results dicts."""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.core.config import EvalConfig as JEvalConfig
from medseg_tpu.data.loader import BatchLoader as JLoader
from medseg_tpu.data.synthetic import synthetic_cls as jsynthetic_cls
from medseg_tpu.eval import csv_io as jcsv
from medseg_tpu.eval import harness as J
from medseg_tpu.ops.augment import preprocess_eval_batch as jpreprocess
from medseg_tpu_torch.core.config import EvalConfig
from medseg_tpu_torch.data.loader import BatchLoader
from medseg_tpu_torch.data.synthetic import synthetic_cls
from medseg_tpu_torch.eval import csv_io
from medseg_tpu_torch.eval import harness as H
from medseg_tpu_torch.interop.from_jax import resnet_classifier_state_dict
from medseg_tpu_torch.models.resnet import resnet18
from medseg_tpu_torch.ops.augment import preprocess_eval_batch
from tests.test_torch_resnet import flax_resnet

torch.set_num_threads(1)

N, SIZE, BATCH = 10, 32, 4  # batches of 4, 4 and a ragged 2


def _quiet(*_):
    pass


def _assert_same_metrics(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def test_evaluate_model_matches_jax():
    """Same weights (carried across by from_jax), same synthetic split: the
    metric dicts and every log line are equal.  The argmax comparison is
    meaningful: no two top logits of the JAX model are within 1e-4."""
    model, variables = flax_resnet(18)
    jds = jsynthetic_cls(N, SIZE)
    x, _ = jpreprocess(jnp.asarray(jds.images))
    top2 = np.sort(np.asarray(model.apply(variables, x, train=False)), -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-4

    jlogs, tlogs = [], []
    want = J.evaluate_model("ResNet18", JLoader(jds, BATCH, shuffle=False),
                            variables, log=jlogs.append)
    loader = BatchLoader(synthetic_cls(N, SIZE), BATCH, shuffle=False, device="cpu")
    assert loader.real_counts() == [4, 4, 2]
    got = H.evaluate_model("ResNet18", loader,
                           resnet_classifier_state_dict(variables, 18),
                           log=tlogs.append, device="cpu")
    _assert_same_metrics(got, want)
    assert got["confusion_matrix"].sum() == N
    assert tlogs == jlogs


def test_reference_pt_checkpoint_loads_strictly(tmp_path):
    """A reference-format .pt (torchvision names, the test oracle's ResNet)
    loads with strict=True, and the metrics are those of that network's own
    forward on the same preprocessed images."""
    from tests.torch_oracles import TResNet, randomize_bn_stats

    torch.manual_seed(0)
    tm = randomize_bn_stats(TResNet(18)).eval()
    wdir = tmp_path / "classification_models"
    wdir.mkdir(parents=True)
    torch.save(tm.state_dict(), wdir / "ResNet18_best_acc.pt")

    ds = synthetic_cls(6, SIZE)
    loader = BatchLoader(ds, 3, shuffle=False, device="cpu")
    res = H.evaluate_model("ResNet18", loader, None,
                           EvalConfig(weights_root=str(tmp_path)), log=_quiet,
                           device="cpu")
    x, _ = preprocess_eval_batch(torch.from_numpy(ds.images))
    with torch.no_grad():
        preds = tm(x.permute(0, 3, 1, 2)).argmax(-1).numpy()
    from medseg_tpu_torch.eval.metrics import classification_metrics

    _assert_same_metrics(res, classification_metrics(preds, ds.labels))
    assert res["confusion_matrix"].sum() == 6


def test_missing_weights_are_skipped(tmp_path):
    loader = BatchLoader(synthetic_cls(4, SIZE), 4, shuffle=False, device="cpu")
    logs, jlogs = [], []
    res = H.evaluate_model("ResNet18", loader, None,
                           EvalConfig(weights_root=str(tmp_path)),
                           log=logs.append, device="cpu")
    J.evaluate_model("ResNet18", JLoader(jsynthetic_cls(4, SIZE), 4, shuffle=False),
                     None, JEvalConfig(weights_root=str(tmp_path)), log=jlogs.append)
    assert res is None and logs == jlogs
    assert any("Weights not found" in line for line in logs)


def test_all_models_without_weights_returns_nothing(tmp_path):
    """Every classification model, ported or not, is skipped for missing
    weights with the JAX package's log lines."""
    from medseg_tpu_torch.eval.harness import test_all_models as run_all

    loader = BatchLoader(synthetic_cls(4, SIZE), 4, shuffle=False, device="cpu")
    logs, jlogs = [], []
    res = run_all(loader, None, EvalConfig(weights_root=str(tmp_path)),
                  log=logs.append, device="cpu")
    jres = J.test_all_models(JLoader(jsynthetic_cls(4, SIZE), 4, shuffle=False),
                             None, JEvalConfig(weights_root=str(tmp_path)),
                             log=jlogs.append)
    assert res == jres == {}
    assert logs == jlogs


def test_segmentation_and_mesh_are_not_ported_yet(tmp_path):
    """Segmentation's last pending model, CLIPSeg (ROADMAP A.12), now
    evaluates: its .pt at the tiny tower config, with the conditional
    embedding from its own text tower, gives the six metrics (the parity
    with the JAX package is tests/test_torch_clip_infer.py's).  The mesh
    branch, which waited for A.14, now evaluates: over a world-1 group it
    gives the metrics of the plain pass, and the caller's loader comes back
    untouched (two ranks: tests/test_torch_parallel.py)."""
    from medseg_tpu_torch.parallel import data_parallel_mesh

    from medseg_tpu_torch.data.synthetic import synthetic_seg
    from tests.torch_clip_helpers import tiny_clip_patched, write_clip_weights

    with tiny_clip_patched(tmp_path):
        root = write_clip_weights(tmp_path / "weights", clip=False)
        seg = BatchLoader(synthetic_seg(4, SIZE), 4, shuffle=False, device="cpu")
        res = H.evaluate_model("CLIPSeg", seg, None, EvalConfig(weights_root=str(root)),
                               log=_quiet, device="cpu")
    assert set(res) == {"iou", "dice", "pixel_accuracy", "precision", "recall", "f1"}
    loader = BatchLoader(synthetic_cls(5, SIZE), 4, shuffle=False, device="cpu")
    sd = resnet18(device="cpu").state_dict()
    plain = H.evaluate_model("ResNet18", loader, sd, log=_quiet, device="cpu")
    meshed = H.evaluate_model("ResNet18", loader, sd, log=_quiet,
                              mesh=data_parallel_mesh("cpu"), device="cpu")
    assert loader.group is None and loader.pad_to_multiple is None
    for k in ("accuracy", "precision", "recall", "f1"):
        assert meshed[k] == plain[k], k


def _results():
    """The results dict of tests/test_eval_harness.py:74-82."""
    return {
        "ResNet18": {"accuracy": 96.8, "precision": 96.8, "recall": 96.8,
                     "f1": 96.8, "confusion_matrix": np.eye(3),
                     "precision_per_class": np.ones(3),
                     "recall_per_class": np.ones(3),
                     "f1_per_class": np.ones(3)},
        "ResNetUnet": {"iou": 96.5, "dice": 98.2, "pixel_accuracy": 99.1,
                       "precision": 97.8, "recall": 98.6, "f1": 98.2},
    }


def _write_both(tmp_path, results):
    paths = {}
    for tag, fn in (("jax", jcsv.save_results_to_csv),
                    ("port", csv_io.save_results_to_csv)):
        cls_path, seg_path = tmp_path / tag / "cls.csv", tmp_path / tag / "seg.csv"
        logs = []
        fn(results, str(cls_path), str(seg_path), log=logs.append)
        paths[tag] = (cls_path, seg_path, logs)
    return paths


def test_csv_is_byte_identical_to_jax(tmp_path):
    paths = _write_both(tmp_path, _results())
    for i in (0, 1):
        assert paths["port"][i].read_bytes() == paths["jax"][i].read_bytes()
    assert paths["port"][0].read_text().splitlines()[0] == \
        "Model,accuracy,precision,recall,f1"
    assert paths["port"][2] == [
        line.replace("/jax/", "/port/") for line in paths["jax"][2]]


@pytest.mark.parametrize("case", ["metrics", "missing_cell", "quoted_name"])
def test_csv_formatting_matches_pandas(tmp_path, case):
    """Real metric values (long float reprs, numpy floats), a model without
    one of the columns, and a model name that needs quoting."""
    if case == "metrics":
        results = {"ResNet18": {"accuracy": 96.83333333333333,
                                "precision": np.float64(2 / 3), "recall": 100.0,
                                "f1": 1e-5},
                   "ResNet50": {"accuracy": 0.0, "precision": 33.33333333333333,
                                "recall": 50.0, "f1": 1e16}}
    elif case == "missing_cell":
        results = {"ResNet18": {"accuracy": 1.5, "precision": 2.5},
                   "ResNet50": {"accuracy": 2.0, "recall": 3.0}}
    else:
        results = {'VGG16 "bn", v2': {"accuracy": 3.0, "precision": 2.0}}
    paths = _write_both(tmp_path, results)
    assert paths["port"][0].read_bytes() == paths["jax"][0].read_bytes()


def test_csv_reads_back_to_the_metrics(tmp_path):
    results = {"ResNet18": {"accuracy": 80.0, "precision": 2 / 3 * 100,
                            "recall": 80.0, "f1": 71.42857142857143}}
    path = tmp_path / "cls.csv"
    csv_io.save_results_to_csv(results, str(path), str(tmp_path / "seg.csv"),
                               log=_quiet)
    with open(path, newline="") as f:
        (row,) = list(csv.DictReader(f))
    assert row.pop("Model") == "ResNet18"
    assert {k: float(v) for k, v in row.items()} == results["ResNet18"]


def test_csv_without_results_writes_nothing(tmp_path):
    logs = []
    csv_io.save_results_to_csv({}, str(tmp_path / "c.csv"), str(tmp_path / "s.csv"),
                               log=logs.append)
    assert logs == ["\n[INFO] No results to save."]
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("which", ["both", "classification", "empty"])
def test_print_summary_text_equals_jax(which):
    results = {
        "ResNet18": {"accuracy": 96.83, "precision": 96.84, "recall": 96.83,
                     "f1": 96.82},
        "ResNet50": {"accuracy": 97.5, "precision": 97.0, "recall": 97.25,
                     "f1": 97.1},
        "ResNetUnet": {"iou": 96.58, "dice": 98.23, "pixel_accuracy": 99.17,
                       "precision": 97.86, "recall": 98.65, "f1": 98.23},
    }
    if which == "classification":
        del results["ResNetUnet"]
    elif which == "empty":
        results = {}
    got, want = [], []
    H.print_summary(results, log=got.append)
    J.print_summary(results, log=want.append)
    assert got == want
