"""The benchmark's frozen copies against the repository's originals, and
its FLOP counts against published figures."""

import importlib.util
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import bounds, data, flops
from benchmark.harness.manifest import ROOT
from benchmark.tests.tiny import full as cell

SHAPES = [(16, 256, 256, 3, 2), (8, 256, 256, 4, 4), (64, 224, 224, 3, 4)]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_original", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", SHAPES)
def test_bounds_equal_the_originals(chip_smoke, shape):
    b, h, w, c, out_bytes = shape
    assert bounds.warp_bound_ms(*shape) == chip_smoke.warp_bound_ms(*shape)
    for per_sample in (True, False):
        assert (bounds.photometric_bound_ms(b, h, w, c, out_bytes, per_sample)
                == chip_smoke.photometric_bound_ms(b, h, w, c, out_bytes, per_sample))
    args = (b * h * w * c * (1 + out_bytes), b * h * w * c * 36.0, 67e12)
    assert bounds.bound_ms(*args) == chip_smoke.bound_ms(*args)
    assert bounds.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert bounds.BF16_FLOPS_PER_S == chip_smoke.BF16_FLOPS_PER_S
    assert bounds.F32_FLOPS_PER_S == chip_smoke.F32_FLOPS_PER_S


def _arch(name, **kw):
    return dict(cell(name).config["architecture"], **kw)


def test_resnet18_forward_is_torchvisions_1814_gmacs():
    arch = _arch("resnet18-train-b128", num_classes=1000, image_size=224)
    assert round(sum(l.macs for l in flops.layers(arch)) / 1e6) == 1814


def test_resnet50_trunk_is_torchvisions_4089_gmacs():
    arch = _arch("resnetunet-train", kind="resnet_classifier", num_classes=1000,
                 image_size=224, dropout=0.5)
    assert round(sum(l.macs for l in flops.layers(arch)) / 1e6) == 4089


def test_train_flops_count_the_frozen_encoder_once():
    arch = _arch("resnetunet-train")
    enc = sum(l.macs for l in flops.layers(arch) if l.name.startswith("encoder."))
    dec = [l for l in flops.layers(arch) if not l.name.startswith("encoder.")]
    expect = 2 * enc + 2 * sum(l.macs * (3 if l.grad_input else 2) for l in dec)
    assert flops.train_flops(arch) == expect
    assert not dec[0].grad_input and all(l.grad_input for l in dec[1:])


def test_resnet18_train_flops_leave_out_the_images_gradient():
    arch = _arch("resnet18-train-b128")
    ls = flops.layers(arch)
    assert flops.train_flops(arch) == 6 * sum(l.macs for l in ls) - 2 * ls[0].macs


@pytest.mark.parametrize("size", [32, 64, 256])
def test_classification_recipe_is_the_originals(size):
    """The program's synthetic_cls: 20 + 100 * label plus noise in [0, 40),
    clipped; the copy draws the same support on the device."""
    from medseg_tpu_torch.data.synthetic import synthetic_cls

    orig = synthetic_cls(n=12, img_size=size, seed=3)
    gen = torch.Generator().manual_seed(3)
    labels = torch.from_numpy(orig.labels)
    ours = data.classification_images(gen, labels, size, 3).numpy()
    for imgs in (orig.images, ours):
        base = (orig.labels * 100 + 20)[:, None, None, None]
        assert ((imgs >= base) & (imgs <= np.minimum(base + 39, 255))).all()


@pytest.mark.parametrize("size", [32, 64, 256])
def test_segmentation_recipe_is_the_originals(size):
    from medseg_tpu_torch.data.synthetic import synthetic_seg

    orig = synthetic_seg(n=6, img_size=size, seed=4)
    images, masks = data.segmentation_images(torch.Generator().manual_seed(4), 6, size)
    for imgs, m in ((orig.images, orig.masks), (images.numpy(), masks.numpy())):
        inside = m == 255
        assert (inside.sum((1, 2)) == (size // 2) ** 2).all()
        assert (imgs[inside] >= 180).all() and (imgs[~inside] < 60).all()
        for i in range(len(imgs)):  # one value fills the square
            assert len(np.unique(imgs[i][inside[i]])) == 1


def test_labels_follow_the_class_ratio():
    counts = cell("resnet18-eval").config["assumed"]["class_counts"]
    labels = data.labels_by_ratio(torch.Generator().manual_seed(0), 200_000, counts).numpy()
    share = np.bincount(labels, minlength=3) / len(labels)
    np.testing.assert_allclose(share, np.array(counts) / sum(counts), atol=0.005)


def test_weights_are_the_seeds():
    from benchmark.reference import models as R

    meta = R.build(cell("resnet18-train-b128").config, "meta")
    a = data.weights(meta, 2**40 + 7, "cpu")
    b = data.weights(meta, 2**40 + 7, "cpu")
    c = data.weights(meta, 2**40 + 8, "cpu")
    assert set(a) == set(meta.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    w = a["layer1.0.conv1.weight"]
    assert abs(float(w.std()) * (64 * 9) ** 0.5 - 1.0) < 0.05
