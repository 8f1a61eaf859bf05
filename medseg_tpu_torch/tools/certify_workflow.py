"""One-session certification of the whole ten-model workflow.

Counterpart of tools/certify_workflow.py.  The reference's defining
artifact is all ten models through train -> finetune -> eval -> CSV ->
summary (reference utils/trainer.py:163-211 -> tester.py:513 ->
results/*.csv).  This tool drives that surface through the port's CLI, one
`python -m medseg_tpu_torch.apps.cli` process a command, on synthetic
packed caches, records each command's wall time, and checks:

  - `train` of each of the 8 CNNs (the two-stage recipe crosses its
    stage switch at CERT_EPOCHS=6) writes its best checkpoint;
  - `finetune-clip --random-init` and `finetune-clipseg --random-init`
    write the two HF-family checkpoints (random towers at full size);
  - `eval` loads all ten from those checkpoints alone, skips none
    ("Skipping" in its log), and writes both reference-schema CSVs with
    5 rows each and the summary, which the report keeps verbatim.

    python -m medseg_tpu_torch.tools.certify_workflow

Knobs: CERT_DIR (the workdir, default a fresh temporary directory),
CERT_EPOCHS (default 6), CERT_SCAN (passes --scan-chunk K to the train
and finetune commands), CERT_IMG (the caches' grid, default 256),
CERT_DEVICE (passed as --device; unset means the card, as the CLI's
default).  The report is <workdir>/CERT_WORKFLOW.json, never the current
directory's (the JAX tool writes there); the transcript goes to stdout.
Exit 0 when every check passed, else 1.
"""

from __future__ import annotations

import csv
import fcntl
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the directory holding the package

MODELS_8 = ("ResNet50", "ResNet18", "VGG16", "VGG19",
            "ResNetUnet", "AttentionUNet", "R2Unet", "R2AttUnet")

# (report key, CLI arguments, whether CERT_SCAN applies): one process
# each, in order ("{epochs}" is CERT_EPOCHS); the cache, weights, results
# and device arguments follow every command.
COMMANDS = tuple(
    [(f"train_{m}", ("train", m, "--epochs", "{epochs}"), True) for m in MODELS_8]
    + [("finetune_clip", ("finetune-clip", "--random-init", "--epochs", "2",
                          "--batch-size", "16"), True),
       ("finetune_clipseg", ("finetune-clipseg", "--random-init", "--epochs", "2",
                             "--batch-size", "8"), True),
       ("eval", ("eval",), False)])

CSV_ROWS = {"classification_test_results.csv": 5, "segmentation_test_results.csv": 5}


def build_synthetic_caches(cache_dir: str, img: int) -> None:
    """Packed caches in the format `pack` writes, at the `img` grid."""
    from medseg_tpu_torch.data.packed import save_packed
    from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg

    save_packed(synthetic_cls(n=64, img_size=img, seed=0), cache_dir, "train_cls")
    save_packed(synthetic_seg(n=32, img_size=img, seed=1), cache_dir, "train_seg")
    save_packed(synthetic_cls(n=16, img_size=img, seed=2), cache_dir, "test_cls")
    save_packed(synthetic_seg(n=16, img_size=img, seed=3), cache_dir, "test_seg")


def run_cmd(argv, log_path: Path, cwd: Path):
    """One CLI process, its output into log_path: (rc, wall s, last lines)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    t0 = time.time()
    with open(log_path, "w") as f:
        rc = subprocess.call([sys.executable, "-m", "medseg_tpu_torch.apps.cli", *argv],
                             stdout=f, stderr=subprocess.STDOUT, cwd=cwd, env=env)
    dt = time.time() - t0
    return rc, dt, log_path.read_text().splitlines()[-25:]


def acquire_workdir_lock(work: Path) -> int:
    """Refuse two runs over one workdir: they would race each other's
    checkpoints and share the card.  The lock lives as long as the
    process."""
    lock_path = work / ".cert.lock"
    fd = os.open(lock_path, os.O_CREAT | os.O_RDWR)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        os.close(fd)
        sys.exit(f"[cert] ABORT: another certify_workflow run holds {lock_path}")
    return fd


def check_outputs(report: dict, eval_log: str, results: Path) -> None:
    """The artifact checks: no model skipped, 5 rows in each CSV, the
    summary kept verbatim."""
    skips = [ln for ln in eval_log.splitlines() if "Skipping" in ln]
    report["eval_skipped_models"] = skips
    if skips:
        report["ok"] = False
        print(f"[cert] EVAL SKIPPED MODELS: {skips}", flush=True)
    rows = {}
    for fname, expect in CSV_ROWS.items():
        path = results / fname
        n = 0
        if path.exists():
            with open(path) as f:
                n = sum(1 for _ in csv.DictReader(f))
        rows[fname] = n
        if n != expect:
            report["ok"] = False
            print(f"[cert] {fname}: {n} rows (expected {expect})", flush=True)
    report["csv_rows"] = rows
    start = eval_log.find("FINAL TEST RESULTS SUMMARY")
    if start == -1:
        start = eval_log.find("SUMMARY")
    report["eval_summary"] = eval_log[start:][:4000] if start >= 0 else ""


def main() -> int:
    work = Path(os.environ.get("CERT_DIR") or tempfile.mkdtemp(prefix="cert_")).resolve()
    epochs = os.environ.get("CERT_EPOCHS", "6")
    scan = os.environ.get("CERT_SCAN", "")
    img = int(os.environ.get("CERT_IMG", "256"))
    device = os.environ.get("CERT_DEVICE", "")
    cache, weights, results, logs = (work / d for d in ("packed", "weights", "results",
                                                        "logs"))
    logs.mkdir(parents=True, exist_ok=True)
    lock = acquire_workdir_lock(work)
    try:
        print(f"[cert] workdir {work}", flush=True)
        build_synthetic_caches(str(cache), img)
        print(f"[cert] synthetic packed caches built ({img}px, the pack format)",
              flush=True)
        report = {"workdir": str(work), "epochs": int(epochs), "device": device or None,
                  "commands": {}, "ok": True}
        common = ["--cache-dir", str(cache), "--weights-root", str(weights),
                  "--results-dir", str(results)] + (["--device", device] if device else [])
        for key, args, scanned in COMMANDS:
            argv = [a.format(epochs=epochs) for a in args] + common
            if scanned and scan:
                argv += ["--scan-chunk", scan]
            rc, dt, tail = run_cmd(argv, logs / f"{key}.log", work)
            report["commands"][key] = {"rc": rc, "wall_s": round(dt, 1), "tail": tail[-6:]}
            print(f"[cert] {key}: {'ok' if rc == 0 else f'FAILED rc={rc}'} in {dt:.0f}s",
                  flush=True)
            if rc != 0:
                report["ok"] = False
                for ln in tail:
                    print(f"    {ln}", flush=True)
        eval_log = logs / "eval.log"
        check_outputs(report, eval_log.read_text() if eval_log.exists() else "", results)
        out = work / "CERT_WORKFLOW.json"
        out.write_text(json.dumps(report, indent=1))
        print(f"[cert] {'PASS' if report['ok'] else 'FAIL'} — report in {out}", flush=True)
        return 0 if report["ok"] else 1
    finally:
        os.close(lock)


if __name__ == "__main__":
    sys.exit(main())
