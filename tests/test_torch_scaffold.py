"""The port's package stands alone: no JAX, no JAX package, no silent CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from medseg_tpu_torch.core.config import EvalConfig
from medseg_tpu_torch.data.loader import BatchLoader
from medseg_tpu_torch.data.synthetic import synthetic_cls
from medseg_tpu_torch.eval import harness
from medseg_tpu_torch.models.resnet import resnet18
from medseg_tpu_torch.ops.kernels import build, photometric, stem_kernel, warp_kernel
from medseg_tpu_torch.ops.warp_fast import warp_affine_fast

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "medseg_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                   ROOT / "dp_scaling.py"]
# transformers too: the card's machine lacks it, and the port reads HF
# state dicts by their names alone
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "medseg_tpu", "transformers")


def test_import_of_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys, medseg_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(medseg_tpu_torch.__path__,"
        " 'medseg_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 32  # every subpackage and module


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported_roots(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = synthetic_cls(n=4, img_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet18()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchLoader(ds, 2, shuffle=False)
    cpu_loader = BatchLoader(ds, 2, shuffle=False, device="cpu")
    cfg = EvalConfig(weights_root="/nonexistent")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.evaluate_model("ResNet18", cpu_loader, None, cfg, log=print)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.test_all_models(cpu_loader, None, cfg, log=print)
    # an explicit CPU request is honoured
    assert next(resnet18(device="cpu").parameters()).device.type == "cpu"
    images, _ = next(iter(cpu_loader))
    assert images.device.type == "cpu"
    assert harness.test_all_models(cpu_loader, None, cfg, log=lambda *_: None,
                                   device="cpu") == {}


def test_train_model_raises_without_a_card(monkeypatch, tmp_path):
    from medseg_tpu_torch.core.config import TrainConfig
    from medseg_tpu_torch.train import train_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loader = BatchLoader(synthetic_cls(n=4, img_size=8), 2, shuffle=False, device="cpu")
    cfg = TrainConfig(epochs=1, save_root=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_model("ResNet18", loader, loader, cfg, log=print)
    # CLIP and CLIPSeg train by their finetune recipes (ROADMAP A.13), not
    # train_model: the JAX package's ValueError, before anything is built
    for name in ("CLIP", "CLIPSeg"):
        with pytest.raises(ValueError, match=f"{name} uses the dedicated finetune recipe"):
            train_model(name, loader, loader, cfg, log=print, device="cpu")
    assert not tmp_path.exists() or not any(tmp_path.iterdir())


def test_every_kernel_source_is_built_and_wrapped():
    """chip_smoke.py builds build.SOURCES; each has a wrapper that names it,
    the TPU kernel it replaces, and a launch count."""
    wrappers = {warp_kernel: warp_kernel.warp_affine_kernel,
                photometric: photometric.fused_photometric,
                stem_kernel: stem_kernel.stem_conv_pool}
    assert sorted(m.SOURCE for m in wrappers) == sorted(build.SOURCES)
    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == sorted(build.SOURCES)
    for module, fn in wrappers.items():
        assert module.REPLACES.startswith("medseg_tpu/ops/pallas/")
        assert isinstance(fn.launches, int)


def test_registry_finds_the_model_factories():
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.models import resnet

    entry = get_model("resnet18")  # case-insensitive, as the reference's dispatch
    assert entry["factory"] is resnet.resnet18 and entry["task"] == "classification"
    assert get_model("ResNet50")["factory"] is resnet.resnet50
    assert get_model("vgg16")["name"] == "VGG16"
    assert get_model("r2attunet")["task"] == "segmentation"
    from medseg_tpu_torch.models import clip, clipseg

    assert get_model("CLIP")["factory"] is clip.clip_classifier
    assert get_model("clipseg")["factory"] is clipseg.clipseg
    assert all(get_model(n)["needs_text_features"] for n in ("CLIP", "CLIPSeg"))
    with pytest.raises(ValueError, match="Unknown model"):
        get_model("UNet3D")


def _warp_inputs(b=2, size=16, c=3):
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (b, size, size, c), np.uint8))
    mats = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, -0.25]]).expand(b, 2, 3)
    return images, mats.contiguous()


@pytest.mark.parametrize("planar", [False, True])
def test_kernel_wrapper_runs_plain_version_only_for_cpu_tensors(planar):
    images, mats = _warp_inputs()
    before = warp_kernel.warp_affine_kernel.launches
    got = warp_kernel.warp_affine_kernel(images, mats, planar=planar)
    assert torch.equal(got, warp_affine_fast(images, mats, planar=planar))
    assert warp_kernel.warp_affine_kernel.launches == before  # no launch on CPU
    with pytest.raises(ValueError, match="no warp kernel"):
        warp_kernel.warp_affine_kernel(images.to("meta"), mats.to("meta"))


@pytest.mark.parametrize("case", ["dtype", "channels", "matrices", "out_dtype",
                                  "mean_without_std", "epilogue_without_alpha"])
def test_kernel_wrapper_validates_inputs(case):
    images, mats = _warp_inputs()
    kw = dict(out_dtype=torch.float32, alpha=None, beta=None, mean=None, std=None)
    if case == "dtype":
        images = images.float()
    elif case == "channels":
        images = torch.zeros(2, 16, 16, 5, dtype=torch.uint8)
    elif case == "matrices":
        mats = mats[:, :, :2]
    elif case == "out_dtype":
        kw["out_dtype"] = torch.float16
    elif case == "mean_without_std":
        kw["mean"] = (0.0, 0.0, 0.0)
    else:
        kw.update(mean=(0.0,) * 3, std=(1.0,) * 3)
    with pytest.raises(ValueError):
        warp_kernel._check(images, mats, **kw)
