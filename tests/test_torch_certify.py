"""The port's certify tool (medseg_tpu_torch/tools/certify_workflow.py) on
the CPU, its command list cut from eleven commands to three: `train
ResNet18`, `train ResNetUnet` and `eval`, at CERT_IMG=32, CERT_EPOCHS=2,
CERT_DEVICE=cpu (~75 s, most of it ResNetUnet's).  Before `eval`,
ResNet18's best checkpoint is deleted: the report must flag it with the
eight models never trained, and nothing of the run may land outside the
workdir.  The full sequence runs on the card (PERF.md §5)."""

import json
import os
from pathlib import Path

import pytest

from medseg_tpu_torch.tools import certify_workflow as C

CUT = ("train_ResNet18", "train_ResNetUnet", "eval")


def test_certify_flags_a_deleted_checkpoint(monkeypatch, tmp_path):
    work, cwd = tmp_path / "cert", tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setenv("CERT_DIR", str(work))
    monkeypatch.setenv("CERT_IMG", "32")
    monkeypatch.setenv("CERT_EPOCHS", "2")
    monkeypatch.setenv("CERT_DEVICE", "cpu")
    monkeypatch.delenv("CERT_SCAN", raising=False)
    monkeypatch.setattr(C, "COMMANDS", tuple(c for c in C.COMMANDS if c[0] in CUT))
    assert [c[0] for c in C.COMMANDS] == list(CUT)
    best = work / "weights" / "classification_models" / "ResNet18_best_acc.pt"
    run_cmd, argvs = C.run_cmd, []

    def delete_before_eval(argv, log_path, cwd):
        argvs.append(argv)
        if argv[0] == "eval":
            assert best.exists()
            best.unlink()
        return run_cmd(argv, log_path, cwd)

    monkeypatch.setattr(C, "run_cmd", delete_before_eval)
    assert C.main() == 1
    report = json.loads((work / "CERT_WORKFLOW.json").read_text())
    assert not any(cwd.iterdir())  # the report lands in the workdir only
    assert report["ok"] is False and report["device"] == "cpu"
    assert [k for k, v in report["commands"].items() if v["rc"] == 0] == list(CUT)
    assert all(a[-2:] == ["--device", "cpu"] for a in argvs)
    assert argvs[0][:4] == ["train", "ResNet18", "--epochs", "2"]
    skipped = {ln.split()[1].rstrip(".") for ln in report["eval_skipped_models"]}
    assert skipped == {"ResNet18", "ResNet50", "VGG16", "VGG19", "CLIP", "AttentionUNet",
                       "R2Unet", "R2AttUnet", "CLIPSeg"}
    assert report["csv_rows"] == {"classification_test_results.csv": 0,
                                  "segmentation_test_results.csv": 1}
    assert "SUMMARY" in report["eval_summary"] and "ResNetUnet" in report["eval_summary"]
    assert (work / "weights" / "segmentation_models" / "ResNetUnet_best_loss.pt").exists()


def test_certify_refuses_a_second_run_over_one_workdir(tmp_path):
    """The workdir lock: a second holder exits at once."""
    fd = C.acquire_workdir_lock(tmp_path)
    try:
        with pytest.raises(SystemExit, match="another certify_workflow run"):
            C.acquire_workdir_lock(Path(tmp_path))
    finally:
        os.close(fd)
