"""Shared fixtures of the zoo tests (tests/test_torch_zoo*.py): each of the
five models of the JAX package beside its port, numpy variables drawn from
a seed, and the converters between their names."""

import contextlib
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import torch

from medseg_tpu.interop import export_torch as E
from medseg_tpu.models.attention_unet import AttentionUNet as JAttentionUNet
from medseg_tpu.models.r2u_net import R2UNet as JR2UNet
from medseg_tpu.models.vgg import VGG16_STAGES, VGG19_STAGES, VGGClassifier as JVGG
from medseg_tpu_torch.core.registry import get_model
from medseg_tpu_torch.interop import from_jax as FJ
from tests.test_torch_resnet import _random_leaf
from tests.torch_oracles import TAttentionUNet, TR2UNet, TVGG

SEG = ("AttentionUNet", "R2Unet", "R2AttUnet")
CLS = ("VGG16", "VGG19")

# name -> (flax model, port state dict of flax variables, the JAX
# package's exporter, the reference-style torch oracle).  The JAX R2 models
# run their recurrence under nn.scan: the same variables and numerics as
# the default unroll (tests/test_recurrent_scan.py), at a fraction of the
# CPU compile time.
SPECS = {
    "AttentionUNet": (JAttentionUNet, FJ.attention_unet_state_dict,
                      E.export_attention_unet, TAttentionUNet),
    "R2Unet": (functools.partial(JR2UNet, t=5, use_scan=True),
               functools.partial(FJ.r2u_net_state_dict, attention=False),
               functools.partial(E.export_r2u_net, attention=False),
               functools.partial(TR2UNet, t=5)),
    "R2AttUnet": (functools.partial(JR2UNet, t=5, attention=True, use_scan=True),
                  functools.partial(FJ.r2u_net_state_dict, attention=True),
                  functools.partial(E.export_r2u_net, attention=True),
                  functools.partial(TR2UNet, t=5, attention=True)),
    "VGG16": (functools.partial(JVGG, VGG16_STAGES),
              functools.partial(FJ.vgg_classifier_state_dict, depth=16),
              functools.partial(E.export_vgg_classifier, depth=16),
              functools.partial(TVGG, 16)),
    "VGG19": (functools.partial(JVGG, VGG19_STAGES),
              functools.partial(FJ.vgg_classifier_state_dict, depth=19),
              functools.partial(E.export_vgg_classifier, depth=19),
              functools.partial(TVGG, 19)),
}


def flax_model(name):
    return SPECS[name][0]()


def state_dict(name, variables):
    return SPECS[name][1](variables)


@functools.lru_cache(maxsize=None)
def flax_variables(name, seed=0, size=32):
    """numpy variables in the tree of flax's init of `name` (traced for
    shapes only), filled from `seed` as tests/test_torch_resnet.py fills
    them: He-scaled kernels, BatchNorm statistics away from 0 and 1."""
    shapes = jax.eval_shape(lambda: flax_model(name).init(
        jax.random.key(0), jnp.zeros((1, size, size, 3))))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _random_leaf(rng, p, s.shape).astype(np.float32), shapes)


def port_model(name, variables, dtype=torch.float32):
    """The port's model on the CPU holding `variables` (strict), its
    dropouts off; a float64 model computes in float64 throughout."""
    model = get_model(name)["factory"](dtype=dtype, device="cpu")
    model.load_state_dict(state_dict(name, variables), strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model.to(dtype) if dtype == torch.float64 else model


def as_port_names(name, params, batch_stats):
    """A flax (params, batch_stats) pair as numpy arrays under the port's
    names and layouts."""
    sd = state_dict(name, {"params": params, "batch_stats": batch_stats})
    return {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}


@contextlib.contextmanager
def flax_dropout_off():
    """flax's Dropout at rate 0 while inside: the JAX VGG's two classifier
    dropouts have a fixed rate of 0.5, and the two frameworks' masks come
    from different generators."""
    original = flax.linen.Dropout
    flax.linen.Dropout = lambda rate, **kw: original(0.0, **kw)
    try:
        yield
    finally:
        flax.linen.Dropout = original


def images(seed, b=2, size=32):
    return np.random.default_rng(seed).normal(0, 1, (b, size, size, 3)).astype(np.float32)


def targets(name, seed, b=2, size=32):
    """Binary masks [B,H,W,1] (a random square each) for a segmenter, class
    labels for a classifier."""
    rng = np.random.default_rng(seed)
    if name in CLS:
        return rng.integers(0, 3, b).astype(np.int32)
    m = np.zeros((b, size, size, 1), np.float32)
    for i in range(b):
        y, x = rng.integers(0, size // 2, 2)
        m[i, y:y + size // 2, x:x + size // 2] = 1.0
    return m
