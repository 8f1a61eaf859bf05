"""The port's Pipeline with VGG16 + AttentionUNet against the JAX package's
on the CPU: both read the same reference `.pt` files (numpy-drawn flax
variables with random BatchNorm statistics, carried through
interop/from_jax; VGG16's head biased to COVID, so the whole cascade runs),
VGG16 on its 224 grid and AttentionUNet on the 256 grid, patched to 64 in
both pipeline modules as tests/test_torch_infer.py patches it."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.infer import pipeline as jpipeline
from medseg_tpu_torch.core.config import EvalConfig
from medseg_tpu_torch.infer import pipeline as tpipeline
from tests import torch_zoo_helpers as Z
from tests.test_torch_infer import _assert_same_verdicts
from tests.torch_infer_helpers import GRID, images

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHAPES = [(80, 96), (300, 260)]  # (H, W): VGG upscales one and downscales the other


@pytest.fixture(scope="module")
def grid64():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipeline, "IMG_SIZE", GRID)
        mp.setattr(jpipeline, "IMG_SIZE", GRID)
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """VGG16_best_acc.pt with classifier.7's bias at 4x the largest |logit|
    of the test images + 10 for COVID, and AttentionUNet_best_loss.pt;
    removed afterwards (VGG16's is 0.5 GB)."""
    base = tmp_path_factory.mktemp("zoo_weights")
    vgg = Z.state_dict("VGG16", Z.flax_variables("VGG16"))
    model = Z.port_model("VGG16", Z.flax_variables("VGG16")).eval()
    grid = tpipeline.Pipeline._grid_batch(images(5, SHAPES), 224, CPU)
    x = (grid.float() / 255.0 - 0.45) / 0.225
    with torch.inference_mode():
        spread = model(x).abs().max().item()
    vgg["classifier.7.bias"] = torch.tensor([4.0 * spread + 10.0, 0.0, 0.0])
    (base / "classification_models").mkdir()
    (base / "segmentation_models").mkdir()
    torch.save(vgg, base / "classification_models" / "VGG16_best_acc.pt")
    torch.save(Z.state_dict("AttentionUNet", Z.flax_variables("AttentionUNet")),
               base / "segmentation_models" / "AttentionUNet_best_loss.pt")
    yield base
    shutil.rmtree(base, ignore_errors=True)


def test_pipeline_vgg16_attention_unet_matches_jax(grid64, root, capsys):
    """Two images of other sizes than the grids: each resized twice, to 224
    for VGG16 and to the U-Net grid for AttentionUNet, in both packages.
    Logits within 1e-3*max(1, |logit|max), probabilities within 1e-3,
    verdicts and overlays as tests/test_torch_infer.py holds them; each
    forward saw the one padded batch shape of its grid."""
    arrays = images(5, SHAPES)
    cfg = dict(weights_root=str(root))
    tp = tpipeline.Pipeline(EvalConfig(**cfg), device="cpu")
    jp = jpipeline.Pipeline(jpipeline.EvalConfig(**cfg))
    for p in (tp, jp):
        p._load_models("VGG16", "AttentionUNet")
    log = capsys.readouterr().out
    assert log.count("Successfully loaded Classification Model: VGG16") == 2
    assert log.count("Successfully loaded Segmentation Model: AttentionUNet") == 2
    got = tp.process_batch(arrays, "AttentionUNet")
    want = jp.process_batch(arrays, "AttentionUNet")
    assert [r[0] for r in got] == ["COVID", "COVID"]
    assert tp._cls[1].seen_batches == {(2, 224, 224, 3)}
    assert tp._seg[1].seen_batches == {(2, GRID, GRID, 3)}

    def jax_forward(entry, size):
        grid = jnp.concatenate([jp._to_grid(jnp.asarray(a[None]), size, "bilinear")
                                for a in arrays])
        return np.asarray(entry[2](grid))

    t_logits = tp._forward(tp._cls[1], tp._grid_batch(arrays, 224, CPU))
    j_logits = jax_forward(jp._cls, 224)
    np.testing.assert_allclose(t_logits, j_logits, rtol=0,
                               atol=1e-3 * max(1.0, np.abs(j_logits).max()))
    t_probs = tp._forward(tp._seg[1], tp._grid_batch(arrays, GRID, CPU))[..., 0]
    j_probs = jax_forward(jp._seg, GRID)[..., 0]
    np.testing.assert_allclose(t_probs, j_probs, rtol=0, atol=1e-3)
    _assert_same_verdicts(got, want, t_probs, j_probs)
    assert all(r[2].shape == a.shape for r, a in zip(got, arrays))
