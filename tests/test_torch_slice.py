"""The whole slice against the JAX package: packed set -> BatchLoader ->
augment_batch (injected draws) -> ResNet18 -> argmax -> classification_metrics,
on the same seed and the same weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.data.loader import BatchLoader as JLoader
from medseg_tpu.data.synthetic import synthetic_cls as jsynthetic_cls
from medseg_tpu.eval.metrics import classification_metrics as jmetrics
from medseg_tpu.ops import augment as JA
from medseg_tpu_torch.data.loader import BatchLoader
from medseg_tpu_torch.data.synthetic import synthetic_cls
from medseg_tpu_torch.eval.metrics import classification_metrics
from medseg_tpu_torch.ops import augment as TA
from tests.test_torch_augment import draw, inject
from tests.test_torch_resnet import SIZE, flax_resnet, port_resnet

torch.set_num_threads(1)

N, BATCH, SEED = 12, 4, 5
# float32 logits of the same network on inputs that agree to 2e-4 (the
# two-pass warp's FMA delta after normalization): 1e-3 absolute, with the
# 1e-4 relative gap of the CPU convolutions' summation order.
LOGIT_TOL = dict(rtol=1e-4, atol=1e-3)


def _assert_same_metrics(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def test_slice_matches_jax(monkeypatch):
    model, variables = flax_resnet(18)
    port = port_resnet(18, variables)
    inject(monkeypatch, [draw(100 + i, BATCH) for i in range(N // BATCH)])

    jlogits, jlabels = [], []
    for images, labels in JLoader(jsynthetic_cls(N, SIZE, seed=SEED), BATCH,
                                  shuffle=True, seed=SEED):
        x, _ = JA.augment_batch(None, images)
        jlogits.append(np.asarray(model.apply(variables, x, train=False)))
        jlabels.append(np.asarray(labels))

    tlogits, tlabels = [], []
    loader = BatchLoader(synthetic_cls(N, SIZE, seed=SEED), BATCH, shuffle=True,
                         seed=SEED, device="cpu", device_cache=True)
    with torch.no_grad():
        for images, labels in loader:
            x, _ = TA.augment_batch(torch.Generator(), images)
            tlogits.append(port(x).numpy())
            tlabels.append(labels.numpy())

    jlogits, tlogits = np.concatenate(jlogits), np.concatenate(tlogits)
    jlabels, tlabels = np.concatenate(jlabels), np.concatenate(tlabels)
    np.testing.assert_array_equal(tlabels, jlabels)
    np.testing.assert_allclose(tlogits, jlogits, **LOGIT_TOL)
    # the argmax comparison below is meaningful: no two top logits are
    # closer than the tolerance
    top2 = np.sort(jlogits, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 10 * LOGIT_TOL["atol"]
    preds = tlogits.argmax(-1)
    np.testing.assert_array_equal(preds, jlogits.argmax(-1))
    _assert_same_metrics(classification_metrics(preds, tlabels),
                         jmetrics(jnp.asarray(jlogits).argmax(-1), jlabels))


@pytest.mark.parametrize("num_classes,n,seed", [(3, 50, 0), (3, 7, 1), (4, 33, 2)])
def test_classification_metrics_match_jax(num_classes, n, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    preds = np.where(rng.random(n) < 0.6, labels, rng.integers(0, num_classes, n))
    if seed == 1:
        preds[:] = 0  # classes never predicted: zero_division=0
    _assert_same_metrics(classification_metrics(preds, labels, num_classes),
                         jmetrics(preds, labels, num_classes))
    # CPU tensors are accepted as they are
    _assert_same_metrics(
        classification_metrics(torch.from_numpy(preds), torch.from_numpy(labels),
                               num_classes),
        jmetrics(preds, labels, num_classes))
