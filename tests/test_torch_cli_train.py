"""The port's CLI train half (ROADMAP A.13, A.15): `train`, `eval`,
`finetune-clip --random-init` and `finetune-clipseg --random-init` through
cli.main on tiny packed caches with --device cpu, the finetuned checkpoints
evaluated and served with no prompt ids, the flags and commands of unported
parts refused by argparse, the offline error without --random-init, and the
random prompt features and embedding against the JAX CLI's draws.

The CNNs train at full width on 32px caches; CLIP and CLIPSeg are the tiny
towers of tests/torch_clip_helpers.py (patched into the registry), on 40px
and 20px caches.
"""

import csv
import types

import numpy as np
import pytest
import torch
from PIL import Image

import medseg_tpu.apps.cli as jcli
import medseg_tpu.core.registry as jregistry
from medseg_tpu_torch.apps import cli
from medseg_tpu_torch.data.packed import save_packed
from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg
from medseg_tpu_torch.train import checkpoint as ckpt
from tests.torch_clip_helpers import PROJ, tiny_clip_patched


def _csv_models(path):
    with open(path, newline="") as f:
        return [row["Model"] for row in csv.DictReader(f)]


def test_cli_train_then_eval(tmp_path, capsys):
    """`train ResNet18 ResNetUnet` (2 epochs, stage 1 of the two-stage
    recipe and the seg stage) writes both best checkpoints and prints the
    JAX CLI's summary lines by task; `eval` (caches found through --root)
    evaluates both into the two CSVs and warns about nothing."""
    packed = tmp_path / "dataset" / "packed"
    save_packed(synthetic_cls(n=40, img_size=32, seed=0), str(packed), "train_cls")
    save_packed(synthetic_seg(n=20, img_size=32, seed=1), str(packed), "train_seg")
    save_packed(synthetic_cls(n=10, img_size=32, seed=2), str(packed), "test_cls")
    save_packed(synthetic_seg(n=6, img_size=32, seed=3), str(packed), "test_seg")
    common = ["--weights-root", str(tmp_path / "w"), "--results-dir", str(tmp_path / "r"),
              "--device", "cpu"]
    cli.main(["train", "ResNet18", "ResNetUnet", "--epochs", "2", "--lr", "1e-4",
              "--cache-dir", str(packed)] + common)
    out = capsys.readouterr().out
    assert "--- Training classification model: ResNet18 ---" in out
    assert "--- Training segmentation model: ResNetUnet ---" in out
    assert "[ResNet18] Ep2:" in out and "[ResNetUnet] Ep2:" in out
    summary = out[out.index("=============== Training Summary"):].splitlines()
    assert summary[1].startswith("ResNet18       : ") and summary[1].endswith(
        "% Acc (Classification)")
    assert summary[2].startswith("ResNetUnet     : ") and summary[2].endswith(
        " Loss (Segmentation)")
    assert (tmp_path / "w" / "segmentation_models" / "ResNetUnet_best_loss.pt").exists()
    assert (tmp_path / "w" / "classification_models" / "ResNet18_best_acc.pt").exists()

    cli.main(["eval", "--root", str(tmp_path / "dataset")] + common)
    out = capsys.readouterr().out
    assert "[WARNING] Classification" not in out and "Testing Segmentation Model: " \
        "ResNetUnet" in out
    assert _csv_models(tmp_path / "r" / "classification_test_results.csv") == ["ResNet18"]
    assert _csv_models(tmp_path / "r" / "segmentation_test_results.csv") == ["ResNetUnet"]

    cli.main(["eval", "--cache-dir", str(tmp_path / "none")] + common)
    out = capsys.readouterr().out
    assert "[WARNING] Classification test cache not found; skipping." in out
    assert "[WARNING] Segmentation test cache not found; skipping." in out


def test_cli_finetune_random_init_then_eval_and_predict(tmp_path, capsys):
    """`finetune-clip --random-init` and `finetune-clipseg --random-init`
    (2 epochs; CLIPSeg's 12 train samples at B=8 end in a ragged 4) write
    CLIP_best_acc.pt and CLIPSeg_best_loss.pt with the JAX CLI's random
    prompt features and embedding as aux; only vision_model.* and
    decoder.* moved from the seeded init.  Then, with $MEDSEG_PROMPT_IDS
    unset, `eval` lists both models in the CSVs and `predict --cls-model
    CLIP --seg-model CLIPSeg` classifies every image."""
    packed = tmp_path / "packed"
    save_packed(synthetic_cls(n=20, img_size=40, seed=0), str(packed), "train_cls")
    save_packed(synthetic_seg(n=14, img_size=20, seed=1), str(packed), "train_seg")
    save_packed(synthetic_cls(n=6, img_size=40, seed=2), str(packed), "test_cls")
    save_packed(synthetic_seg(n=4, img_size=20, seed=3), str(packed), "test_seg")
    weights = tmp_path / "w"
    common = ["--cache-dir", str(packed), "--weights-root", str(weights), "--results-dir",
              str(tmp_path / "r"), "--device", "cpu"]
    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(4)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (30, 36, 3), dtype=np.uint8)).save(
            src / f"x{i}.png")
    with tiny_clip_patched(tmp_path), pytest.MonkeyPatch.context() as mp:
        mp.delenv("MEDSEG_PROMPT_IDS")
        cli.main(["finetune-clip", "--random-init", "--epochs", "2", "--batch-size", "8"]
                 + common)
        cli.main(["finetune-clipseg", "--random-init", "--epochs", "2", "--batch-size", "8"]
                 + common)
        out = capsys.readouterr().out
        assert "[CLIP] Ep2:" in out and "[CLIPSeg] Ep2:" in out
        assert "--random-init: finetuning a RANDOMLY initialized CLIP " in out
        for name, seg, key, want, init, trains in (
                ("CLIP", False, "text_features", cli.random_prompt_features(PROJ),
                 cli.random_init_clip("cpu")[0], "vision_model."),
                ("CLIPSeg", True, "cond", cli.random_cond(PROJ),
                 cli.random_init_clipseg("cpu")[0], "decoder.")):
            sub = "segmentation_models" if seg else "classification_models"
            suffix = "best_loss" if seg else "best_acc"
            sd, aux = ckpt.split_aux(torch.load(weights / sub / f"{name}_{suffix}.pt",
                                                weights_only=True))
            assert torch.equal(aux[key], torch.from_numpy(want))
            for k, v in init.state_dict().items():
                assert torch.equal(sd[k], v) != k.startswith(trains), k
            init.load_state_dict(sd, strict=True)
        cli.main(["eval"] + common)
        out = capsys.readouterr().out
        assert "Weights not found for CLIP" not in out and "Failed to test" not in out
        assert _csv_models(tmp_path / "r" / "classification_test_results.csv") == ["CLIP"]
        assert _csv_models(tmp_path / "r" / "segmentation_test_results.csv") == ["CLIPSeg"]
        cli.main(["predict", "--input", str(src), "--output", str(tmp_path / "out"),
                  "--cls-model", "CLIP", "--seg-model", "CLIPSeg", "--batch-size", "2"]
                 + common)
    with open(tmp_path / "out" / "predictions.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["file"] for r in rows] == ["x0.png", "x1.png", "x2.png"]
    assert all(r["prediction"] in ("COVID", "Healthy", "Non-COVID") for r in rows)


@pytest.mark.parametrize("argv", [
    ["train", "--data-parallel"], ["train", "--scan-chunk", "2"],
    ["train", "--auto-restart", "1"], ["eval", "--auto-restart", "1"],
    ["parity", "--data-parallel"], ["eval", "--data-parallel"],
    ["finetune-clip", "--scan-chunk", "2"], ["finetune-clipseg", "--data-parallel"],
    ["finetune-clipseg", "--scan-chunk", "2"],
    ["install-data"], ["bench"], ["export-torch", "ResNet18"],
], ids=lambda a: "_".join(a))
def test_cli_refuses_unported_flags(argv, capsys):
    """argparse refuses what is not ported.  --data-parallel of train, eval
    and the finetuners (ROADMAP A.14) and --scan-chunk of train and the
    finetuners are ported now: argparse takes them, and the command goes on
    to its own refusal, the no-card error without --device cpu (train,
    eval) or the offline error without --random-init (the finetuners),
    never a silent fallback."""
    if argv[0] != "parity" and ("--data-parallel" in argv or "--scan-chunk" in argv):
        match = "could not load" if argv[0].startswith("finetune") else "no CUDA device"
        with pytest.raises(RuntimeError, match=match):
            cli.main(argv)
        return
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "unrecognized arguments" in err or (
        argv[0] in ("install-data", "bench", "export-torch") and "invalid choice" in err)


@pytest.mark.parametrize("cmd,name", [("finetune-clip", "openai/clip-vit-base-patch32"),
                                      ("finetune-clipseg", "CIDAS/clipseg-rd64-refined")])
def test_finetune_without_random_init_is_the_offline_error(cmd, name, tmp_path):
    with pytest.raises(RuntimeError, match=f"could not load {name} from HuggingFace "
                                           r"\(offline environment\?\)"):
        cli.main([cmd, "--cache-dir", str(tmp_path), "--device", "cpu"])


def test_random_draws_equal_the_jax_clis(monkeypatch):
    """The prompt features and the conditional embedding of --random-init
    are the JAX CLI's (its _random_init_clip / _random_init_clipseg, with a
    stub model whose init returns nothing)."""
    stub = types.SimpleNamespace(init=lambda *a, **k: {})
    for key in ("clip", "clipseg"):
        monkeypatch.setitem(jregistry._REGISTRY[key], "factory", lambda **_: stub)
    _, tf = jcli._random_init_clip()
    _, cond = jcli._random_init_clipseg()
    np.testing.assert_array_equal(cli.random_prompt_features(512), tf)
    np.testing.assert_array_equal(cli.random_cond(512), cond)
