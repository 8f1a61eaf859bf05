"""utils/debug and apps/eda of the port against the JAX package's, on the CPU.

nan_check_mode: the first operation with a NaN output raises, in the
forward and in the backward, naming the operation, and the state before
the block returns; assert_finite flags the paths JAX's flags, in its
format.  eda: get_dataset_stats on a temporary PNG tree against JAX's,
the three plots against JAX's (axes, titles, images, bar heights), and
the module imports where matplotlib is absent."""

import collections
import contextlib
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from medseg_tpu.apps import eda as jeda
from medseg_tpu.utils.debug import assert_finite as jassert_finite
from medseg_tpu_torch.apps import eda
from medseg_tpu_torch.nn.blocks import BatchNorm2d, Conv2d
from medseg_tpu_torch.utils import assert_finite, nan_check_mode

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


# --- (g) nan_check_mode -----------------------------------------------------------

def _tiny_model():
    torch.manual_seed(0)
    return torch.nn.Sequential(Conv2d(3, 4, 3, 1, 1), BatchNorm2d(4), torch.nn.ReLU())


def test_nan_check_mode_raises_on_a_forward_nan_and_restores():
    """A NaN weight: inside the mode the conv's output raises
    FloatingPointError naming the ATen operation; outside, before and after,
    the same forward returns NaN silently, also after a raise inside."""
    model = _tiny_model().eval()
    with torch.no_grad():
        model[0].weight[0, 0, 0, 0] = float("nan")
    x = torch.randn(2, 3, 8, 8)
    assert torch.isnan(model(x)).any()
    with pytest.raises(FloatingPointError, match=r"NaN in the output of aten\.\w+"):
        with nan_check_mode():
            model(x)
    assert torch.isnan(model(x)).any()
    with nan_check_mode():
        assert not torch.isnan(model[2](x)).any()  # a clean op passes
    assert torch.isnan(torch.tensor([-1.0]).sqrt()).all()


def test_nan_check_mode_skips_allocations():
    """An allocation's output is unwritten memory, NaN bit patterns or not
    (a kernel launched outside ATen fills it on the card): resize_ of a
    NaN tensor returns it without a raise; a computed NaN still raises."""
    x = torch.full((2,), float("nan"))
    with nan_check_mode():
        y = x.resize_(3)
        with pytest.raises(FloatingPointError, match="aten.add"):
            x.add(1.0)
    assert torch.isnan(y[:2]).all()


def test_nan_check_mode_sees_the_backward():
    """sqrt(x - x) is 0 in the forward; its backward makes inf - inf = NaN
    in the gradient's accumulation: raised from inside backward()."""
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    with nan_check_mode():
        y = (x - x).pow(0.5).sum()
        assert float(y.detach()) == 0.0
        with pytest.raises(FloatingPointError, match=r"NaN in the output of aten\."):
            y.backward()


def test_nan_check_mode_passes_a_clean_train_step():
    """A train-mode forward, backward and AdamW step without a NaN pass
    inside the mode, and give what they give outside it."""
    x = torch.randn(2, 3, 8, 8)
    states = []
    for check in (False, True):
        model = _tiny_model().train()
        opt = torch.optim.AdamW(model.parameters(), 1e-3)
        with nan_check_mode() if check else contextlib.nullcontext():
            model(x).square().mean().backward()
            opt.step()
        states.append(model.state_dict())
    assert all(torch.equal(v, states[1][k]) for k, v in states[0].items())


def _nested_tree(nan_leaf=np.nan):
    return {"b": {"z": np.array([nan_leaf]), "a": [np.ones(2), np.array([np.inf])]},
            "a": collections.OrderedDict([("y", np.array([nan_leaf])),
                                          ("x", np.array([1.0]))]),
            "c": None, "d": (np.array([np.nan]), np.arange(3)), "e": 7,
            "f": {"g": np.array([np.nan]), "h": np.array([np.nan])}}


def _message(fn, tree):
    with pytest.raises(FloatingPointError) as info:
        fn(tree, "params")
    return str(info.value)


def test_assert_finite_flags_what_jax_flags():
    """The same nested dicts, OrderedDicts, lists, tuples and None: the
    same message, paths in jax.tree_util.keystr's format and order (a
    dict's keys sorted, an OrderedDict's in order), at most 5 of the 6."""
    msg = _message(assert_finite, _nested_tree())
    assert msg == _message(jassert_finite, _nested_tree())
    assert msg.startswith("non-finite values in params: [\"['a']['y']\"")
    assert msg.count("['") >= 5 and "['h']" not in msg
    assert_finite({"a": np.ones(3), "b": [torch.ones(2)], "c": None}, "clean")
    jassert_finite({"a": np.ones(3), "b": [np.ones(2)], "c": None}, "clean")


def test_assert_finite_names_the_poisoned_state_dict_key():
    """A model's state_dict (float32 parameters and statistics, an integer
    count) with one tensor poisoned: exactly its key, as JAX's on the same
    arrays."""
    model = _tiny_model()
    sd = model.state_dict()
    assert_finite(sd, "state_dict")
    sd["1.running_var"][2] = float("inf")
    with pytest.raises(FloatingPointError) as info:
        assert_finite(sd, "state_dict")
    assert str(info.value) == "non-finite values in state_dict: [\"['1.running_var']\"]"
    want = _message(jassert_finite, collections.OrderedDict(
        (k, v.numpy()) for k, v in sd.items()))
    assert str(info.value) == want.replace("params", "state_dict")
    # a bfloat16 tensor is checked too; JAX's np.asarray test reads its
    # bfloat16 as dtype kind 'V' and passes it: a difference kept on purpose
    bf16 = {"w": torch.tensor([1.0, float("nan")], dtype=torch.bfloat16)}
    with pytest.raises(FloatingPointError, match=r"\['w'\]"):
        assert_finite(bf16)
    jassert_finite({"w": jnp.asarray([1.0, np.nan], jnp.bfloat16)})


# --- (h) eda ------------------------------------------------------------------------

COUNTS = {"COVID": (4, 3), "Healthy": (2, 2), "Non-COVID": (0, 0)}  # images, masks


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    """3 classes: COVID 4 images (the last without a mask), Healthy 2 (a
    mask at another size, resized nearest by the triptych), Non-COVID
    none (its directory missing: the warning)."""
    root = tmp_path_factory.mktemp("eda") / "dataset"
    rng = np.random.default_rng(0)
    for cls, (n_img, n_mask) in COUNTS.items():
        if not n_img:
            continue
        (root / cls / "images").mkdir(parents=True)
        (root / cls / "masks").mkdir()
        for i in range(n_img):
            name = f"{cls}-{i}.png"
            Image.fromarray(rng.integers(0, 256, (20, 24, 3), np.uint8)).save(
                root / cls / "images" / name)
            if i < n_mask:
                size = (24, 20) if cls == "COVID" else (12, 10)
                m = (rng.random(size[::-1]) > 0.5).astype(np.uint8) * 255
                Image.fromarray(m).save(root / cls / "masks" / name)
    return str(root)


def test_get_dataset_stats_matches_jax(png_tree, capsys):
    """Counts, the first 10 paths and the missing directory's warning, as
    JAX's."""
    got = eda.get_dataset_stats(png_tree)
    out = capsys.readouterr().out
    want = jeda.get_dataset_stats(png_tree)
    assert got == want and capsys.readouterr().out == out
    assert {c: (s["images"], s["masks"]) for c, s in got.items()} == COUNTS
    assert "Warning: Image directory not found" in out and "Non-COVID" in out


def _describe(fig):
    """What a figure shows: each axes' title, its images' shapes and
    first pixels, its bars' heights and its texts."""
    import matplotlib

    out = []
    for ax in fig.axes:
        out.append((ax.get_title(), ax.get_ylabel(),
                    [(im.get_array().shape, np.asarray(im.get_array()).ravel()[:8].tolist())
                     for im in ax.get_images()],
                    [p.get_height() for p in ax.patches
                     if isinstance(p, matplotlib.patches.Rectangle)],
                    [t.get_text() for t in ax.texts]))
    return out


@pytest.mark.parametrize("plot", ["visualize_samples", "visualize_image_mask_pairs"])
def test_sample_plots_match_jax(png_tree, plot):
    """The same grid of axes with the same titles and images as JAX's."""
    import matplotlib.pyplot as plt

    kw = dict(n_samples=3, data_root=png_tree)
    got, want = getattr(eda, plot)(**kw), getattr(jeda, plot)(**kw)
    try:
        assert len(got.axes) == len(want.axes) == 3 * (3 if plot == "visualize_samples" else 9)
        assert _describe(got) == _describe(want)
        assert sum(len(ax.get_images()) for ax in got.axes) > 0
    finally:
        plt.close(got)
        plt.close(want)


def test_class_distribution_matches_jax(png_tree, tmp_path):
    """Bar heights, pie labels and percentages as JAX's; save_path writes
    a PNG."""
    import matplotlib.pyplot as plt

    stats = eda.get_dataset_stats(png_tree)
    got = eda.plot_class_distribution(stats, save_path=str(tmp_path / "dist.png"))
    want = jeda.plot_class_distribution(stats)
    try:
        assert _describe(got) == _describe(want)
        assert _describe(got)[0][3] == [4, 2, 0]
        assert (tmp_path / "dist.png").stat().st_size > 0
    finally:
        plt.close(got)
        plt.close(want)


def test_eda_imports_without_matplotlib(png_tree):
    """With matplotlib blocked, the module imports and counts; only the
    plots need it."""
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "from medseg_tpu_torch.apps import eda\n"
            f"s = eda.get_dataset_stats({png_tree!r})\n"
            "assert s['COVID']['images'] == 4, s\n"
            "try:\n    eda.plot_class_distribution(s)\nexcept ImportError:\n"
            "    print('plots need matplotlib')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "plots need matplotlib" in out.stdout
