"""The plain reference held against the program at 64px on the CPU: the
models' forwards, the augmentation (the card's branch, computed by the
kernels' plain versions) and the eval preprocessing, from the same
weights and the same draws."""

import pytest
import torch

from benchmark.harness import data
from benchmark.tests.tiny import full as cell
from benchmark.reference import augment as A
from benchmark.reference import models as R
from benchmark.tests import tiny

SIZE = 64


def _pair(name, seed=11):
    from medseg_tpu_torch.core.registry import get_model

    cfg = tiny.cell(name, size=SIZE).config
    w = data.weights(R.build(cfg, "meta"), seed, "cpu")
    port = get_model(cfg["model"])["factory"](dtype=torch.float32, device="cpu")
    port.load_state_dict(w, strict=True)
    ref = R.build(cfg, "cpu")
    ref.load_state_dict(w, strict=True)
    return cfg, port, ref


@pytest.mark.parametrize("train", [False, True])
def test_resnet18_forward(train):
    cfg, port, ref = _pair("resnet18-train-b128")
    x = torch.randn(4, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(1))
    port.train(train)
    ref.train(train)
    if train:
        out = port(x, generator=torch.Generator().manual_seed(5))
        keep = A.dropout_keep(torch.Generator().manual_seed(5), 4, 512, 0.5)
        want = ref(x, keep)
    else:
        out, want = port(x), ref(x)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_resnet_unet_forward(train):
    cfg, port, ref = _pair("resnetunet-train")
    x = torch.randn(2, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(2))
    port.train(train)
    ref.train(train)
    torch.testing.assert_close(port(x), ref(x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seg", [False, True])
def test_augmentation_is_the_cards(seg):
    from medseg_tpu_torch.ops.augment import augment_batch

    g = torch.Generator().manual_seed(9)
    images, masks = data.segmentation_images(g, 6, SIZE)
    with tiny.card_branch():
        x, m = augment_batch(torch.Generator().manual_seed(4), images,
                             masks if seg else None, out_dtype=torch.float32)
    d = A.draw(torch.Generator().manual_seed(4), 6)
    rx, rm = A.augment(images, d, masks if seg else None)
    torch.testing.assert_close(x, rx, rtol=0, atol=1e-4)
    if seg:
        assert torch.equal(m, rm)


def test_eval_preprocess_is_the_programs():
    from medseg_tpu_torch.ops.augment import preprocess_eval_batch

    images, _ = data.segmentation_images(torch.Generator().manual_seed(1), 3, SIZE)
    torch.testing.assert_close(preprocess_eval_batch(images)[0], A.eval_preprocess(images),
                               rtol=0, atol=1e-6)


def test_dropout_draw_follows_the_augmentation():
    """The reference's draw order: nine rows of the global batch for the
    augmentation, then the head's mask, as the program's step draws."""
    from medseg_tpu_torch.nn.blocks import dropout
    from medseg_tpu_torch.ops.augment import sample_augment_params
    from medseg_tpu_torch.core.config import AugmentConfig

    g = torch.Generator().manual_seed(3)
    p = sample_augment_params(g, 5, AugmentConfig())
    kept = dropout(torch.ones(5, 512), 0.5, g) > 0
    g2 = torch.Generator().manual_seed(3)
    d = A.draw(g2, 5)
    assert torch.equal(A.dropout_keep(g2, 5, 512, 0.5), kept)
    assert torch.equal(d.flip, p.flip) and torch.equal(d.alpha, p.alpha)
    assert cell("resnet18-train-b128").config["architecture"]["dropout"] == 0.5
