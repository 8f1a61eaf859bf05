"""The port's package stands alone: no JAX, no JAX package, no silent CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from medseg_tpu_torch.data.loader import BatchLoader
from medseg_tpu_torch.data.synthetic import synthetic_cls
from medseg_tpu_torch.models.resnet import resnet18
from medseg_tpu_torch.ops.kernels import warp_kernel
from medseg_tpu_torch.ops.warp_fast import warp_affine_fast

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "medseg_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "medseg_tpu")


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
    assert int(out.stdout.split()[-1]) >= 20  # every subpackage and module


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
    # an explicit CPU request is honoured
    assert next(resnet18(device="cpu").parameters()).device.type == "cpu"
    images, _ = next(iter(BatchLoader(ds, 2, shuffle=False, device="cpu")))
    assert images.device.type == "cpu"


def test_registry_finds_the_model_factories():
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.models import resnet

    entry = get_model("resnet18")  # case-insensitive, as the reference's dispatch
    assert entry["factory"] is resnet.resnet18 and entry["task"] == "classification"
    assert get_model("ResNet50")["factory"] is resnet.resnet50
    with pytest.raises(ValueError, match="Unknown model"):
        get_model("VGG16")


def _warp_inputs(b=2, size=16, c=3):
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (b, size, size, c), np.uint8))
    mats = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, -0.25]]).expand(b, 2, 3)
    return images, mats.contiguous()


def test_kernel_wrapper_runs_plain_version_only_for_cpu_tensors():
    images, mats = _warp_inputs()
    before = warp_kernel.warp_affine_kernel.launches
    got = warp_kernel.warp_affine_kernel(images, mats)
    assert torch.equal(got, warp_affine_fast(images, mats))
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
