"""Driver `eval_passes`: the evaluation harness's classification pass over
the test split, pass after pass.

The program's path is the one `medseg eval` takes for a classifier
(medseg_tpu_torch/eval/harness.py): the CLI's test loader (BatchLoader
without a device cache: each batch a host gather and a copy), the model
from the registry in the float32 the harness builds, in eval mode, under
the process's default TF32 flags, and `_eval_classification`, the body of
`evaluate_model`: one preprocessing launch (B2's eval form) and one
forward a batch, predictions kept on the device and fetched once a pass.
The window counts the test images whose predictions reached the host.

Every pass's predictions are taken where the harness hands them to
`metrics.classification_metrics`, and its logits where the model's forward
returns them (a forward hook): the two observers the benchmark puts on the
program.  After the window both are compared with the reference's float32
logits of the same images (harness/compare.py `logit_gap`, `logit_rms_err`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness import data as D
from benchmark.harness import manifest, runner, trace
from benchmark.harness.trace import span

_DATA, _WEIGHTS = 0, 1


class Recorder:
    """Wraps the harness's metrics call to keep each pass's (preds, labels)."""

    def __init__(self, metrics_module):
        self.module = metrics_module
        self.inner = metrics_module.classification_metrics
        self.passes = []

    def __call__(self, preds, labels, *args, **kw):
        self.passes.append((np.asarray(preds).copy(), np.asarray(labels).copy()))
        return self.inner(preds, labels, *args, **kw)

    def __enter__(self):
        self.module.classification_metrics = self
        return self

    def __exit__(self, *exc):
        self.module.classification_metrics = self.inner
        return False


def measure(cell, seed: int, seconds: float, trace_on: bool, device, t_start: float,
            precision: str = "float32"):
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.packed import PackedDataset
    from medseg_tpu_torch.eval import harness as H
    from medseg_tpu_torch.eval import metrics as M
    from benchmark.reference import steps as ref

    log = runner.SetupLog(t_start)
    cfg, tr = cell.config, cell.traffic
    arch, assumed = cfg["architecture"], cfg["assumed"]
    arrays = D.dataset("classification", assumed["test_split"], arch["image_size"],
                       assumed["class_counts"], seed, device, _DATA)
    log.mark("imports and data")
    loader = BatchLoader(PackedDataset(arrays["images"], arrays["labels"]), tr["batch_per_chip"],
                         shuffle=False, device=device)
    weights = D.weights(manifest.reference(cfg).build(cfg, "meta"), seed, device, _WEIGHTS)
    with torch.device(device):  # the factory's own initialization runs on the device
        model = get_model(cfg["model"])["factory"](device=device)
    model.load_state_dict(weights, strict=True)
    model.eval()
    log.mark("weights, model")
    n = len(arrays["labels"])
    logits = []  # each pass's forwards' outputs, as the harness's argmax read them
    hook = model.register_forward_hook(lambda mod, args, out: logits[-1].append(out.detach()))
    with Recorder(M) as rec:
        logits.append([])
        H._eval_classification(model, loader, device, {}, None)  # warms every shape
        rec.passes.clear()
        logits.clear()
        setup_s = time.time() - t_start
        log.mark("first pass")
        log.print()
        session = trace.Session(device, enabled=trace_on)
        passes = 0
        with session:
            t0 = time.perf_counter()
            while True:
                logits.append([])
                with span("eval pass"):
                    H._eval_classification(model, loader, device, {}, None)
                passes += 1
                elapsed = time.perf_counter() - t0
                if elapsed >= (tr["trace_seconds"] if trace_on else seconds):
                    break
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    hook.remove()
    got_logits = [torch.cat(p).float().cpu().numpy() for p in logits]
    del model, loader, logits
    if device.type == "cuda":
        torch.cuda.empty_cache()
    images = torch.from_numpy(arrays["images"]).to(device)
    ref_logits = ref.logits(cfg, weights, images, precision).cpu().numpy()
    yardstick = ref.logits(cfg, weights, images, "tf32").cpu().numpy()
    got = rec.passes
    numbers = {"logit_gap": compare.logit_gap(ref_logits, arrays["labels"], got),
               "logit_rms_err": compare.logit_rms_err(ref_logits, got_logits),
               "logit_rms_ratio": compare.logit_rms_ratio(ref_logits, got_logits, yardstick)}
    answered = sum(len(p) for p, _ in got)
    counters = {"images": answered, "passes": passes, "batches": passes * -(-n // tr["batch_per_chip"]),
                "window_s": elapsed, "chips": cell.chips,
                "b2_rows": answered, "b2_shape": [arch["image_size"], arch["image_size"], 3, 4]}
    return runner.Outcome(e2e={"eval_img_per_s": answered / elapsed, "setup_s": setup_s},
                          counters=counters, numbers=numbers, attempted=passes * n,
                          failed=passes * n - answered, memory_peak_bytes=peak,
                          session=session if trace_on else None)


def run(cell, seed: int, seconds: float, trace_on: bool, device, t_start: float) -> dict:
    return runner.finish(cell, measure(cell, seed, seconds, trace_on, device, t_start),
                         trace_on, device)
