"""The port's trainer against the JAX package's on two models of the rest of
the CNN zoo: a 2-epoch run of both from the same initial weights at 32px,
AttentionUNet through the segmentation branch and VGG16 through the
two-stage recipe (stage1_epochs=1, so the stage switch happens), and each
run's best checkpoint through both packages' eval harnesses.
Augmentation is off (the two packages draw from different generators) and
so are VGG's three dropouts, in both."""

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.core.config import AugmentConfig as JAugmentConfig
from medseg_tpu.core.config import EvalConfig as JEvalConfig
from medseg_tpu.core.config import TrainConfig as JTrainConfig
from medseg_tpu.data.loader import BatchLoader as JLoader
from medseg_tpu.data.synthetic import synthetic_cls as jsynthetic_cls
from medseg_tpu.data.synthetic import synthetic_seg as jsynthetic_seg
from medseg_tpu.eval import harness as JH
from medseg_tpu.models.attention_unet import AttentionUNet as JAttentionUNet
from medseg_tpu.models.vgg import VGGClassifier as JVGG
from medseg_tpu.train import steps as JS
from medseg_tpu.train import train_model as jtrain_model
from medseg_tpu_torch.core.config import AugmentConfig, EvalConfig, TrainConfig
from medseg_tpu_torch.core.registry import get_model
from medseg_tpu_torch.data.loader import BatchLoader
from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg
from medseg_tpu_torch.eval import harness as H
from medseg_tpu_torch.train import checkpoint as ckpt
from medseg_tpu_torch.train import steps as TS
from medseg_tpu_torch.train import trainer as T
from tests import torch_zoo_helpers as Z

torch.set_num_threads(1)

N_TRAIN, N_VAL, SIZE, BATCH, VBATCH, SEED = 8, 4, 32, 4, 2, 3
NO_AUG = dict(affine_p=0.0, hflip_p=0.0, brightness_contrast_p=0.0)
# float32; the segmentation run at lr 1e-4, as tests/test_torch_seg_trainer.py
# runs ResNetUnet; VGG's stage 1 (the classifier) at 1e-5 and stage 2 at the
# recipe's 1e-6: at 1e-3 AdamW moves classifier.0's 25088 inputs a step
# together, and the logits reach the hundreds
CFG = {"AttentionUNet": dict(epochs=2, lr=1e-4, compute_dtype="float32"),
       "VGG16": dict(epochs=2, stage1_epochs=1, stage1_lr=1e-5, lr=1e-6,
                     compute_dtype="float32")}
JMODEL = {"AttentionUNet": JAttentionUNet, "VGG16": JVGG}
SEG_LINE = re.compile(r"\[AttentionUNet\] Ep(\d+): TrainLoss ([\d.]+) \| ValLoss ([\d.]+) "
                      r"\| IoU ([\d.]+)")
CLS_LINE = re.compile(r"\[VGG16\] Ep(\d+): TrainLoss ([\d.]+) \(Acc ([\d.]+)%\) "
                      r"\| ValLoss ([\d.]+) \| ValAcc ([\d.]+)%")
NUMBER = re.compile(r"-?\d+\.\d+")


def _data(name, jax_side):
    seg = name in Z.SEG
    if jax_side:
        return (jsynthetic_seg if seg else jsynthetic_cls)(N_TRAIN + N_VAL, SIZE)
    return (synthetic_seg if seg else synthetic_cls)(N_TRAIN + N_VAL, SIZE)


def _loaders(name, jax_side=False):
    ds, kw = _data(name, jax_side), ({} if jax_side else {"device": "cpu"})
    Loader = JLoader if jax_side else BatchLoader
    return (Loader(ds, BATCH, shuffle=True, seed=SEED, indices=np.arange(N_TRAIN), **kw),
            Loader(ds, VBATCH, shuffle=False,
                   indices=np.arange(N_TRAIN, N_TRAIN + N_VAL), **kw))


def _jax_init(name):
    """Initial variables in the tree of flax's init (traced for shapes
    only): kernels drawn with numpy from flax's lecun_normal variance
    1/fan_in, biases 0, BatchNorm scale 1, bias 0, mean 0, var 1."""
    shapes = jax.eval_shape(lambda: Z.flax_model(name).init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3))))
    rng = np.random.default_rng(0)

    def leaf(path, shape):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(shape.shape[:-1]))
            return rng.normal(0, np.sqrt(1.0 / fan_in), shape.shape).astype(np.float32)
        return np.full(shape.shape, path[-1].key in ("scale", "var"), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _recording(monkeypatch, module, lrs):
    original = module.set_learning_rate

    def record(state, lr):
        lrs.append(lr)
        return original(state, lr)

    monkeypatch.setattr(module, "set_learning_rate", record)


def _dropouts_off(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


@pytest.fixture(scope="module", params=["AttentionUNet", "VGG16"])
def both_runs(request, tmp_path_factory):
    """One 2-epoch run of each trainer from _jax_init, float32: the JAX
    trainer's model.init returns it, and the port's init_weights loads it.
    The port's run saves its best checkpoint under a temporary root,
    removed afterwards (VGG16's is 0.5 GB), and no resume file (1.6 GB
    with AdamW's moments; tests/test_torch_trainer.py tests resuming)."""
    name = request.param
    mp = pytest.MonkeyPatch()
    try:
        init = _jax_init(name)
        sd = Z.state_dict(name, init)
        mp.setattr(JMODEL[name], "init", lambda self, *args, **kw: init)
        mp.setattr(T, "init_weights", lambda model, gen: model.load_state_dict(sd))
        entry = get_model(name)
        factory = entry["factory"]
        mp.setitem(entry, "factory", lambda **kw: _dropouts_off(factory(**kw)))
        jlrs, tlrs = [], []
        _recording(mp, JS, jlrs)
        _recording(mp, TS, tlrs)
        mp.setattr(ckpt, "save_resume", lambda *args, **kw: None)
        jlogs = []
        with Z.flax_dropout_off():
            jres = jtrain_model(name, *_loaders(name, jax_side=True),
                                JTrainConfig(**CFG[name]), JAugmentConfig(**NO_AUG),
                                seed=0, save=False, log=jlogs.append)
        root = tmp_path_factory.mktemp(f"port_{name}")
        tlogs = []
        tres = T.train_model(name, *_loaders(name), TrainConfig(**CFG[name],
                                                                save_root=str(root)),
                             AugmentConfig(**NO_AUG), seed=0, save=True,
                             log=tlogs.append, device="cpu")
    finally:
        mp.undo()
    yield dict(name=name, jres=jres, jlogs=jlogs, jlrs=jlrs, tres=tres, tlogs=tlogs,
               tlrs=tlrs, root=root)
    shutil.rmtree(root, ignore_errors=True)


# Against a float64 run of the port's trainer (the same runs with the
# model in float64): AttentionUNet's printed epoch figures are up to 0.002
# from JAX's float32 run (0.001 from the port's), and its best validation
# loss 1.9e-4 relative (the port's 6.3e-4); VGG16's printed figures and
# best accuracy are equal in all three.  Each tolerance is three times the
# larger distance, or one unit of the printed third decimal.
EPOCH_TOL = {"AttentionUNet": 6.001e-3, "VGG16": 1.001e-3}
BEST_RTOL = {"AttentionUNet": 2e-3, "VGG16": 0.0}


def test_two_epochs_match_jax(both_runs):
    """The same LR sequence (exactly), the same other lines (VGG16's stage
    lines among them), each epoch's printed accuracies equal and its
    losses and IoU within EPOCH_TOL, the same best score within BEST_RTOL
    and the same epoch count."""
    r, name = both_runs, both_runs["name"]
    line = SEG_LINE if name in Z.SEG else CLS_LINE
    assert r["tlrs"] == r["jlrs"] == ([1e-4, 5e-5] if name in Z.SEG else [1e-5, 1e-6])
    other = lambda logs: [s for s in logs if not line.match(s)  # noqa: E731
                          and not s.startswith(f"Training for {name} finished in")]
    assert other(r["tlogs"]) == other(r["jlogs"])
    if name in Z.CLS:
        assert any("STAGE 2" in s for s in r["tlogs"])
    got, want = ([tuple(float(v) for v in m.groups()) for m in map(line.match, logs) if m]
                 for logs in (r["tlogs"], r["jlogs"]))
    assert [e[0] for e in got] == [e[0] for e in want] == [1, 2]
    for g, w in zip(got, want):
        if name in Z.CLS:
            assert (g[2], g[4]) == (w[2], w[4])  # train and validation accuracy
            g, w = (g[1], g[3]), (w[1], w[3])
        np.testing.assert_allclose(g, w, rtol=0, atol=EPOCH_TOL[name])
    np.testing.assert_allclose(r["tres"].best_score, r["jres"].best_score,
                               rtol=BEST_RTOL[name])
    assert r["tres"].epochs_run == r["jres"].epochs_run == 2


def test_best_checkpoint_evaluates_in_both_harnesses(both_runs):
    """The port's best .pt, read from disk by the JAX package's harness
    (.pt branch) and by the port's, through test_all_models over the
    validation split (the zoo's other models have no weights and are
    skipped) and print_summary: the same log lines but for their figures,
    each metric within 1e-3 (in %) of the other."""
    r, name = both_runs, both_runs["name"]
    if name in Z.CLS and r["tres"].best_score <= 0.0:
        pytest.fail("no best checkpoint: validation accuracy stayed at 0%")
    weights = str(r["root"])
    seg = name in Z.SEG
    jloader, tloader = _loaders(name, jax_side=True)[1], _loaders(name)[1]
    jlogs, tlogs = [], []
    jres = JH.test_all_models(None if seg else jloader, jloader if seg else None,
                              JEvalConfig(weights_root=weights), log=jlogs.append)
    tres = H.test_all_models(None if seg else tloader, tloader if seg else None,
                             EvalConfig(weights_root=weights), log=tlogs.append,
                             device="cpu")
    JH.print_summary(jres, log=jlogs.append)
    H.print_summary(tres, log=tlogs.append)
    assert list(tres) == list(jres) == [name]
    assert [NUMBER.sub("#", s) for s in tlogs] == [NUMBER.sub("#", s) for s in jlogs]
    for k, v in jres[name].items():
        np.testing.assert_allclose(np.asarray(tres[name][k], np.float64),
                                   np.asarray(v, np.float64), rtol=0, atol=1e-3, err_msg=k)
