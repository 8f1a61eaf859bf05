"""The port's data-parallel training at W=2 against itself at W=1.

Two gloo processes on the CPU (tests/torch_dist_worker.py) run the seg
step, train_model and the CLIPSeg finetuner on their rows of each global
batch; this process runs the same at W=1 on the global batch.  Then the
CLI: `train --data-parallel` and `eval --data-parallel` under MEDSEG_* in
two processes against one process.
"""

import csv
import gc
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from medseg_tpu_torch.apps import cli
from medseg_tpu_torch.data.packed import save_packed
from medseg_tpu_torch.data.synthetic import synthetic_cls
from tests import torch_dist_worker as W

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EPOCH = re.compile(r"\[\w+\] Ep(\d+): (.*)")


def numbers(line: str):
    return [float(v) for v in re.findall(r"-?\d+\.\d+", line)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks first, then the one-process runs (the seg step holds ~4 GB
    a process: never three at once)."""
    work = tmp_path_factory.mktemp("dp_train")
    cases = ["seg", "trainer", "clipseg"]
    with W.spawn_ranks(work, cases) as collect:
        ranks = collect()
    gc.collect()
    one = {c: W.CASES[c](W.WORLD1, work) for c in cases}
    return ranks, one


def test_seg_step_matches_one_process(run):
    """One float64 ResNetUnet step (frozen encoder whose BatchNorms train on
    the global batch's statistics, the augmentation with its mask drawn for
    the global batch) at W=2 against W=1: the loss, and every parameter's
    and running statistic's summary (sum, sum of squares, a fixed
    projection) within 1e-9 of its largest, the clipped gradients' within
    1e-9 of the largest gradient summary (a conv bias feeding a BatchNorm
    has an exactly zero gradient, noise near 1e-20); both ranks alike bit
    for bit; the encoder without gradients."""
    ranks, one = run
    r0, r1 = (r for r in ranks["seg"])
    one = one["seg"]
    assert r0.keys() == one.keys()
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-9)
    assert not any(k.startswith("grad/encoder") for k in one)
    assert any(k.startswith("grad/") for k in one)
    gmax = max(v.abs().max().item() for k, v in one.items() if k.startswith("grad/"))
    for k, v in one.items():
        assert torch.equal(torch.as_tensor(r0[k]), torch.as_tensor(r1[k])), k
        if k != "loss":
            scale = gmax if k.startswith("grad/") else v.abs().max().item()
            assert (r0[k] - v).abs().max().item() <= 1e-9 * scale, k


def _logged(logs):
    return [(int(m.group(1)), numbers(m.group(2))) for m in map(EPOCH.match, logs) if m]


def test_train_model_matches_one_process_and_rank0_writes(run):
    """train_model("ResNet18") float32 for 2 epochs (the stage switch after
    the first) at W=2 against W=1: the same epoch lines (as logged, to
    their last digit or one unit of it), the same best score, the
    parameters within 2 * (3 * 1e-3 + 3 * 1e-6) of each other (AdamW moves
    an element whose gradient is float32 noise by up to its lr either way)
    and all but 1 in 10^4 within 1e-5, the running statistics within 1e-4;
    rank 0 wrote the best and resume checkpoints that W=1 wrote, rank 1
    none; the caller's loaders come back untouched (checked in each
    rank)."""
    ranks, one = run
    r0, r1 = (r for r in ranks["trainer"])
    one = one["trainer"]
    assert r0["best"] == r1["best"] == one["best"]
    lines0, lines1 = _logged(r0["logs"]), _logged(one["logs"])
    assert [e for e, _ in lines0] == [e for e, _ in lines1] == [1, 2]
    for (_, a), (_, b) in zip(lines0, lines1):
        np.testing.assert_allclose(a, b, rtol=0, atol=1.01e-3)
    assert r0["logs"] == r1["logs"]
    assert r0["saved"] and r0["saved"] == one["saved"] and r1["saved"] == []
    n_off = n_all = 0
    for k, v in one.items():
        if k.startswith("param/"):
            diff = (r0[k] - v).abs()
            assert diff.max().item() <= 2 * (3e-3 + 3e-6), k
            n_off += int((diff > 1e-5).sum())
            n_all += diff.numel()
        elif k.startswith("buffer/"):
            np.testing.assert_allclose(r0[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    assert n_off <= 1e-4 * n_all, (n_off, n_all)


def test_finetune_clipseg_matches_one_process(run):
    """The tiny CLIPSeg's decoder step at W=2 (a global batch of 4, the
    dice's intersection and denominators summed over the ranks through
    all_reduce_sum, whose backward sums too) against W=1: the loss within
    1e-6 relative and the clipped gradients within 1e-5 of the largest
    (an identity backward would leave the dice's share half as large); then
    finetune_clipseg for an epoch: the same epoch line to its last digit
    and the same best dice within 1e-5."""
    ranks, one = run
    r0, r1 = (r for r in ranks["clipseg"])
    one = one["clipseg"]
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-6)
    grads = {k: v for k, v in one.items() if k.startswith("grad/")}
    assert grads and all(k.startswith("grad/decoder.") for k in grads)
    gmax = max(v.abs().max().item() for v in grads.values())
    for k, v in grads.items():
        np.testing.assert_allclose(r0[k].numpy(), v.numpy(), rtol=0, atol=1e-5 * gmax,
                                   err_msg=k)
    np.testing.assert_allclose(r0["best"], one["best"], rtol=0, atol=1e-5)
    assert r0["best"] == r1["best"]
    lines0, lines1 = _logged(r0["logs"]), _logged(one["logs"])
    assert len(lines0) == 1
    np.testing.assert_allclose(lines0[0][1], lines1[0][1], rtol=0, atol=1.01e-3)


# --- the CLI ------------------------------------------------------------------

def run_cli_ranks(tmp: Path, argv, world: int = 2, timeout: float = 240.0):
    """`python -m medseg_tpu_torch.apps.cli ARGV` as `world` ranks joined by
    MEDSEG_* through a file store, rank r in tmp/rank{r}; their outputs.
    Every rank is killed on the way out."""
    store = tmp / f"store-{argv[0]}"
    procs = []
    try:
        for r in range(world):
            (tmp / f"rank{r}").mkdir(exist_ok=True)
            env = dict(os.environ, MEDSEG_COORDINATOR=f"file://{store}",
                       MEDSEG_NUM_PROCESSES=str(world), MEDSEG_PROCESS_ID=str(r),
                       PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "medseg_tpu_torch.apps.cli", *argv],
                cwd=tmp / f"rank{r}", env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-6000:]}"
        assert f"[INFO] multi-host: process {r}/{world}" in out, out
        assert f"[INFO] data-parallel over {world} devices" in out, out
    return outs


def _rows(path: Path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_cli_train_and_eval_data_parallel(tmp_path, capsys):
    """`train ResNet18 --data-parallel --device cpu` as two ranks under
    MEDSEG_* writes (rank 0 only: paths are relative to each rank's
    directory) the resume checkpoint that one process writes with
    `--data-parallel` (a world-1 group): the head's parameters within
    2 * 4 * 1e-4 (4 stage-1 steps at lr 1e-4) and the running statistics
    within 1e-4.  Then `eval --data-parallel` of its weights as two ranks
    (5 test images in batches of 4: the tail of 1 padded to 2) writes rank
    0's CSV, equal to one process's `eval` within rel 1e-4."""
    packed = tmp_path / "packed"
    save_packed(synthetic_cls(n=20, img_size=W.IMG, seed=7), str(packed), "train_cls")
    save_packed(synthetic_cls(n=5, img_size=W.IMG, seed=8), str(packed), "test_cls")
    train = ["train", "ResNet18", "--epochs", "1", "--batch-size", "4", "--dtype", "float32",
             "--cache-dir", str(packed), "--device", "cpu", "--data-parallel"]
    run_cli_ranks(tmp_path, train)
    assert not (tmp_path / "rank1" / "weights").exists()
    cli.main(train + ["--weights-root", str(tmp_path / "one")])
    assert "[INFO] data-parallel over 1 devices" in capsys.readouterr().out
    resume = Path("classification_models") / "ResNet18_resume.pt"
    got = torch.load(tmp_path / "rank0" / "weights" / resume, weights_only=True)["model"]
    want = torch.load(tmp_path / "one" / resume, weights_only=True)["model"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.startswith("fc."):
            assert (got[k] - v).abs().max().item() <= 2 * 4 * 1e-4, k
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        else:  # frozen in stage 1
            assert torch.equal(got[k], v), k

    weights = tmp_path / "eval_weights" / "classification_models"
    weights.mkdir(parents=True)
    torch.save(want, weights / "ResNet18_best_acc.pt")
    common = ["--cache-dir", str(packed), "--weights-root", str(weights.parent),
              "--batch-size", "4", "--device", "cpu"]
    run_cli_ranks(tmp_path, ["eval", "--data-parallel"] + common)
    cli.main(["eval", "--results-dir", str(tmp_path / "one_results")] + common)
    name = "classification_test_results.csv"
    assert not (tmp_path / "rank1" / "results").exists()
    got, want = _rows(tmp_path / "rank0" / "results" / name), _rows(tmp_path / "one_results" / name)
    assert got[0] == want[0] and len(got) == len(want) == 2
    assert got[1][0] == want[1][0] == "ResNet18"
    np.testing.assert_allclose([float(v) for v in got[1][1:]], [float(v) for v in want[1][1:]],
                               rtol=1e-4)
