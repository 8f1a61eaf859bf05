"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program either."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness import guard
from benchmark.harness.manifest import HERE, ROOT


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(*parts):
    return [p for p in HERE.joinpath(*parts).rglob("*.py") if "tests" not in p.parts]


def test_top_level_names_compare_whole():
    assert guard.forbidden(["jax.numpy", "flax.linen", "medseg_tpu.ops"]) == [
        "flax", "jax", "medseg_tpu"]
    assert guard.forbidden(["medseg_tpu_torch.train", "jaxtyping", "flaxen"]) == []


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert guard.forbidden(_imports(path)) == [], path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert "medseg_tpu_torch" not in tops and not guard.forbidden(tops), path


def test_a_run_loads_none_of_them():
    """A cell driven end to end on the CPU in a fresh interpreter."""
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.harness import guard, manifest\n"
        "c = tiny.cell('resnet18-eval')\n"
        "manifest.driver(c.traffic['driver']).run(c, 1, 0.01, False, torch.device('cpu'), time.time())\n"
        "print(guard.forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_a_machine_without_cards(tmp_path):
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "resnetunet-train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
