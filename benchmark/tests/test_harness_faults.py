"""A run with the timed path broken underneath comes out not correct: each
fault the cells can have, planted in the program on the CPU at a tiny
size; and the control, the reference a precision below, fails a number."""

import dataclasses
import json
import time
from pathlib import Path
from unittest import mock

import pytest
import torch

from benchmark.harness import compare, manifest
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2**35 + 1


def _f32(c):
    c.config["recipe"]["compute_dtype"] = "float32"
    return c


def _run(c, *patches):
    with tiny.card_branch():
        for p in patches:
            p.start()
        try:
            return manifest.driver(c.traffic["driver"]).run(c, SEED, 0.01, False, CPU, time.time())
        finally:
            for p in patches:
                p.stop()


def _unchanged_state():
    from medseg_tpu_torch.train.steps import ClippedAdamW, clip_by_global_norm_

    def step(self, closure=None):  # clips, and updates nothing
        clip_by_global_norm_([p.grad for g in self.param_groups for p in g["params"]
                              if p.grad is not None], self.clip_norm)

    return mock.patch.object(ClippedAdamW, "step", step)


def _half_batch(name):
    from medseg_tpu_torch.train import losses

    orig = getattr(losses, name)

    def half(logits, targets, *a):
        n = max(1, logits.shape[0] // 2)
        return orig(logits[:n], targets[:n], *a)

    return mock.patch.object(losses, name, half)


@pytest.mark.parametrize("name, loss", [("resnet18-train-b128", "cross_entropy"),
                                        ("resnetunet-train", "bce_with_logits")])
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_train_faults(name, loss, fault):
    c = _f32(tiny.cell(name))
    patch = _unchanged_state() if fault == "unchanged" else _half_batch(loss)
    r = _run(c, patch)
    assert r["correct"] is False, r["checks"]


def test_eval_answer_altered_where_produced():
    from medseg_tpu_torch.eval import harness as H

    orig = H._split_rows

    def altered(parts, loader):
        rows = orig(parts, loader).clone()
        rows[0, 0] = (rows[0, 0] + 1) % 3
        return rows

    r = _run(tiny.cell("resnet18-eval"), mock.patch.object(H, "_split_rows", altered))
    assert r["correct"] is False, r["checks"]


def _rank_without_exchange(*args):
    """dp_train_epochs' rank with every all-reduce of the program's group
    left out."""
    from medseg_tpu_torch.parallel.sharding import DataParallelGroup

    from benchmark.drivers import dp_train_epochs

    with mock.patch.object(DataParallelGroup, "all_reduce_", lambda self, t: t), tiny.card_branch():
        dp_train_epochs._rank(*args)


def test_exchange_between_chips_left_out(tmp_path):
    import torch.multiprocessing as mp

    from benchmark.drivers import dp_train_epochs

    c = _f32(tiny.dp_cell(train_split=40))
    ctx = mp.get_context("spawn")
    port = dp_train_epochs._free_port()
    procs = [ctx.Process(target=_rank_without_exchange,
                         args=(r, 2, port, c, SEED, 0.01, False, time.time(), str(tmp_path), True))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    assert [p.exitcode for p in procs] == [0, 0]
    r = json.loads(Path(tmp_path, "rank0.json").read_text())["result"]
    assert r["correct"] is False, r["checks"]


def test_train_control_fails():
    """fp8 in the bf16 program's place, at 64px: its numbers fail the cell's limits."""
    from benchmark.drivers import train_epochs as T
    from benchmark.reference import steps as ref

    c = tiny.cell("resnet18-train-b128", size=64, batch=8, train_split=60)
    with tiny.card_branch():
        t = T.Trainer(c, SEED, CPU)
        r = t.first_steps()
    rows, b = r["rows"], c.traffic["batch_per_chip"]
    batches = T.batches(c, rows, t.arrays, CPU)
    low = ref.follow(c.config, t.weights, batches, t.gen_seed, r["groups"], 1e-6, "fp8")
    numbers = T.check(c, dict(low, rows=rows, groups=r["groups"]), t.weights, t.arrays,
                      t.gen_seed, CPU)
    assert not compare.passed(compare.judge(numbers, c.limits)), numbers


def test_eval_control_fails():
    """bfloat16 in the TF32 program's place: its logits fail the limits."""
    from benchmark.harness import data as D
    from benchmark.reference import models as R
    from benchmark.reference import steps as ref

    c = tiny.cell("resnet18-eval", size=64, test_split=256)
    cfg = c.config
    arrays = D.dataset("classification", 256, 64, cfg["assumed"]["class_counts"], SEED, CPU, 0)
    w = D.weights(R.build(cfg, "meta"), SEED, CPU, 1)
    images = torch.from_numpy(arrays["images"])
    hi = ref.logits(cfg, w, images).numpy()
    low = ref.logits(cfg, w, images, "bfloat16").numpy()
    yard = ref.logits(cfg, w, images, "tf32").numpy()
    numbers = {"logit_gap": compare.logit_gap(hi, arrays["labels"], [(low.argmax(1), arrays["labels"])]),
               "logit_rms_ratio": compare.logit_rms_ratio(hi, [low], yard)}
    assert not compare.passed(compare.judge(numbers, c.limits)), numbers
