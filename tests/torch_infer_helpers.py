"""Shared set-up of the inference tests (test_torch_infer.py,
test_torch_server.py, test_torch_zoo_infer.py): JAX-initialized ResNet18
and ResNetUnet variables with random BatchNorm statistics, written once as
the reference's `.pt` state dicts through the port's interop/from_jax,
which both packages' pipelines then read; the rest of the CNN zoo's `.pt`
from the port's init; and seeded uint8 test images."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from medseg_tpu.core.registry import get_model as jget_model
from medseg_tpu_torch.core.registry import get_model
from medseg_tpu_torch.interop.from_jax import (resnet_classifier_state_dict,
                                               resnet_unet_state_dict)
from medseg_tpu_torch.models.resnet import init_weights, resnet18

GRID = 64  # IMG_SIZE of both pipeline modules in these tests


@functools.lru_cache(maxsize=None)
def jax_variables(name: str):
    """flax init (jitted) from key 0 at the test grid; running statistics
    redrawn from numpy (mean N(0, 0.1), var U(0.5, 1.5)) so folding them
    is real work."""
    model = jget_model(name)["factory"]()
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, GRID, GRID, 3)))
    rng = np.random.default_rng(1)

    def stat(path, leaf):
        shape = np.shape(leaf)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


def images(seed: int, shapes):
    """Seeded RGB uint8 images of the given (H, W)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in shapes]


@functools.lru_cache(maxsize=None)
def forcing_bias() -> float:
    """A head bias that makes its class win: 4x the largest |logit| over a
    probe of seeded images, + 10."""
    model = resnet18(device="cpu")
    model.load_state_dict(resnet_classifier_state_dict(jax_variables("ResNet18"), 18))
    probe = np.stack(images(99, [(GRID, GRID)] * 8)).astype(np.float32)
    x = (torch.from_numpy(probe) / 255.0 - 0.45) / 0.225
    with torch.inference_mode():
        spread = model.eval()(x).abs().max().item()
    return 4.0 * spread + 10.0


def write_weights(root, winner=None, cls=True, seg=True):
    """The reference's .pt files under `root`: ResNet18 (its head biased
    toward class index `winner`, or as initialized) and ResNetUnet."""
    if cls:
        sd = resnet_classifier_state_dict(jax_variables("ResNet18"), 18)
        if winner is not None:
            bias = torch.zeros(3)
            bias[winner] = forcing_bias()
            sd["fc.1.bias"] = bias
        (root / "classification_models").mkdir(parents=True, exist_ok=True)
        torch.save(sd, root / "classification_models" / "ResNet18_best_acc.pt")
    if seg:
        (root / "segmentation_models").mkdir(parents=True, exist_ok=True)
        torch.save(resnet_unet_state_dict(jax_variables("ResNetUnet")),
                   root / "segmentation_models" / "ResNetUnet_best_loss.pt")
    return root


def write_zoo_weights(root, name, seed=0):
    """The reference's .pt file of zoo model `name` under `root`: the port's
    init_weights from a CPU generator seeded `seed`."""
    entry = get_model(name)
    model = init_weights(entry["factory"](device="cpu"), torch.Generator().manual_seed(seed))
    seg = entry["task"] == "segmentation"
    sub = root / ("segmentation_models" if seg else "classification_models")
    sub.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(),
               sub / f"{entry['name']}_{'best_loss' if seg else 'best_acc'}.pt")
    return root
