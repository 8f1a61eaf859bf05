"""The port's segmentation trainer against the JAX package's: a 2-epoch
ResNetUnet run of both from the same initial weights on synthetic_seg at
64px, the best checkpoint read by both eval harnesses, and resume against
the uninterrupted run.  Augmentation is off (the two packages draw from
different generators), so both take the CPU branch of augment_batch with
identity parameters.  The loaders are unshuffled, since a resumed run
restarts them as the JAX trainer does."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medseg_tpu.core.config import AugmentConfig as JAugmentConfig
from medseg_tpu.core.config import EvalConfig as JEvalConfig
from medseg_tpu.core.config import TrainConfig as JTrainConfig
from medseg_tpu.data.loader import BatchLoader as JLoader
from medseg_tpu.data.synthetic import synthetic_seg as jsynthetic_seg
from medseg_tpu.eval import harness as JH
from medseg_tpu.models.resnet_unet import ResNetUnet as JResNetUnet
from medseg_tpu.train import steps as JS
from medseg_tpu.train import train_model as jtrain_model
from medseg_tpu_torch.core.config import AugmentConfig, EvalConfig, TrainConfig
from medseg_tpu_torch.data.loader import BatchLoader
from medseg_tpu_torch.data.synthetic import synthetic_seg
from medseg_tpu_torch.eval import harness as H
from medseg_tpu_torch.interop.from_jax import resnet_unet_state_dict
from medseg_tpu_torch.models import resnet_unet as tunet
from medseg_tpu_torch.train import checkpoint as ckpt
from medseg_tpu_torch.train import steps as TS
from medseg_tpu_torch.train import trainer as T

torch.set_num_threads(1)

N_TRAIN, N_VAL, SIZE, BATCH, VBATCH = 4, 3, 64, 2, 2
CFG = dict(epochs=2, lr=1e-4, compute_dtype="float32")
NO_AUG = dict(affine_p=0.0, hflip_p=0.0, brightness_contrast_p=0.0)
EPOCH_LINE = re.compile(r"\[ResNetUnet\] Ep(\d+): TrainLoss ([\d.]+) \| ValLoss ([\d.]+) "
                        r"\| IoU ([\d.]+)")
NUMBER = re.compile(r"-?\d+\.\d+")


def _port_loaders():
    ds = synthetic_seg(N_TRAIN + N_VAL, SIZE)
    return (BatchLoader(ds, BATCH, shuffle=False, indices=np.arange(N_TRAIN),
                        device="cpu"),
            BatchLoader(ds, VBATCH, shuffle=False,
                        indices=np.arange(N_TRAIN, N_TRAIN + N_VAL), device="cpu"))


def _jax_val_loader():
    return JLoader(jsynthetic_seg(N_TRAIN + N_VAL, SIZE), VBATCH, shuffle=False,
                   indices=np.arange(N_TRAIN, N_TRAIN + N_VAL))


@functools.lru_cache(maxsize=None)
def _jax_init():
    """Initial variables in the tree of flax's init (traced for shapes
    only; run eagerly it takes ~40 s here, jitted ~17 s): kernels drawn
    with numpy from flax's lecun_normal variance 1/fan_in, biases 0,
    BatchNorm scale 1, bias 0, mean 0, var 1."""
    shapes = jax.eval_shape(lambda: JResNetUnet().init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3))))
    rng = np.random.default_rng(0)

    def leaf(path, shape):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(shape.shape[:-1]))
            return rng.normal(0, np.sqrt(1.0 / fan_in), shape.shape).astype(np.float32)
        return np.full(shape.shape, name in ("scale", "var"), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_init_state_dict():
    return resnet_unet_state_dict(_jax_init())


def _from_jax_init(monkeypatch):
    """Both trainers start from _jax_init: the JAX trainer's model.init
    returns it, and the port's init_weights loads it."""
    sd = _jax_init_state_dict()
    monkeypatch.setattr(JResNetUnet, "init", lambda self, *args, **kw: _jax_init())
    monkeypatch.setattr(T, "init_weights", lambda model, gen: model.load_state_dict(sd))


def _recording(monkeypatch, module, lrs):
    original = module.set_learning_rate

    def record(state, lr):
        lrs.append(lr)
        return original(state, lr)

    monkeypatch.setattr(module, "set_learning_rate", record)


def _quiet(*_):
    pass


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """One 2-epoch run of each trainer: float32, augmentation off, both from
    _jax_init.  The port's run saves its checkpoints under a temporary
    root."""
    mp = pytest.MonkeyPatch()
    try:
        jlrs, tlrs = [], []
        _recording(mp, JS, jlrs)
        _recording(mp, TS, tlrs)
        _from_jax_init(mp)
        jds = jsynthetic_seg(N_TRAIN + N_VAL, SIZE)
        jlogs = []
        jres = jtrain_model(
            "ResNetUnet",
            JLoader(jds, BATCH, shuffle=False, indices=np.arange(N_TRAIN)),
            _jax_val_loader(), JTrainConfig(**CFG), JAugmentConfig(**NO_AUG),
            seed=0, save=False, log=jlogs.append)
        root = tmp_path_factory.mktemp("port_seg_run")
        tlogs = []
        tres = T.train_model("ResNetUnet", *_port_loaders(),
                             TrainConfig(**CFG, save_root=str(root)),
                             AugmentConfig(**NO_AUG), seed=0, save=True,
                             log=tlogs.append, device="cpu")
    finally:
        mp.undo()
    return dict(jres=jres, jlogs=jlogs, jlrs=jlrs, tres=tres, tlogs=tlogs,
                tlrs=tlrs, root=root)


def _epochs(logs):
    return [tuple(float(v) for v in m.groups()) for m in map(EPOCH_LINE.match, logs) if m]


def test_two_epochs_match_jax(both_runs):
    """The same LR sequence (cosine over all epochs, exactly), the same
    other lines, and each epoch's train loss, validation loss and IoU
    within one unit of their printed third decimal; the same best score
    (the lowest validation loss, 1e-4 relative) and epoch count."""
    r = both_runs
    assert r["tlrs"] == r["jlrs"] == [1e-4, 5e-5]
    other = lambda logs: [s for s in logs if not EPOCH_LINE.match(s)  # noqa: E731
                          and not s.startswith("Training for ResNetUnet finished in")]
    assert other(r["tlogs"]) == other(r["jlogs"])
    assert r["tlogs"][0] == "Training Segmentation model (all layers unfrozen) with LR: 0.0001"
    got, want = _epochs(r["tlogs"]), _epochs(r["jlogs"])
    assert [e[0] for e in got] == [e[0] for e in want] == [1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[1:], w[1:], rtol=0, atol=1.001e-3)
    np.testing.assert_allclose(r["tres"].best_score, r["jres"].best_score, rtol=1e-4)
    assert r["tres"].epochs_run == r["jres"].epochs_run == 2


def test_frozen_encoder_and_checkpoints(both_runs):
    """After the run the encoder holds the initial weights bit for bit while
    its running statistics moved; the decoder trained.  The best file is
    segmentation_models/ResNetUnet_best_loss.pt, and the resume file
    records stage 1."""
    init = _jax_init_state_dict()
    got = both_runs["tres"].model.state_dict()
    for name, value in got.items():
        if name.endswith("num_batches_tracked"):
            continue
        same = torch.equal(value, init[name])
        if name.startswith("encoder") and not name.endswith(("running_mean", "running_var")):
            assert same, name
        elif name.endswith(("weight", "running_var")):
            assert not same, name
    seg_dir = both_runs["root"] / "segmentation_models"
    assert sorted(p.name for p in seg_dir.iterdir()) == ["ResNetUnet_best_loss.pt",
                                                         "ResNetUnet_resume.pt"]
    assert not (both_runs["root"] / "classification_models").exists()
    assert ckpt.load_resume(str(seg_dir), "ResNetUnet")["meta"]["stage"] == 1


def test_best_checkpoint_evaluates_in_both_harnesses(both_runs):
    """The port's ResNetUnet_best_loss.pt, read from disk by the JAX
    package's harness (.pt branch) and by the port's, through
    test_all_models over the validation split (the other segmentation
    models have no weights and are skipped) and print_summary: the same
    log lines but for their figures, each metric within 1e-3 (in %) of
    the other, and the same logits on a batch (1e-4 of the largest)."""
    weights = str(both_runs["root"])
    jlogs, tlogs = [], []
    jres = JH.test_all_models(None, _jax_val_loader(), JEvalConfig(weights_root=weights),
                              log=jlogs.append)
    tres = H.test_all_models(None, _port_loaders()[1], EvalConfig(weights_root=weights),
                             log=tlogs.append, device="cpu")
    JH.print_summary(jres, log=jlogs.append)
    H.print_summary(tres, log=tlogs.append)
    assert list(tres) == list(jres) == ["ResNetUnet"]
    assert [NUMBER.sub("#", s) for s in tlogs] == [NUMBER.sub("#", s) for s in jlogs]
    assert tres["ResNetUnet"].keys() == jres["ResNetUnet"].keys()
    for k, v in jres["ResNetUnet"].items():
        np.testing.assert_allclose(tres["ResNetUnet"][k], v, rtol=0, atol=1e-3, err_msg=k)

    variables, _ = JH.load_model_bundle("ResNetUnet", weights, seg=True)
    model = tunet.resnet_unet(device="cpu")
    sd, _ = H.load_model_bundle("ResNetUnet", weights, seg=True)
    model.load_state_dict(sd, strict=True)
    images = np.random.default_rng(0).normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(JResNetUnet().apply(variables, jnp.asarray(images)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_resume_equals_uninterrupted_run(both_runs, tmp_path, monkeypatch):
    """A run cut after epoch 1 and resumed to epoch 2 ends with the
    uninterrupted run's parameters, running statistics and best score, bit
    for bit: AdamW's moments and step are restored, the cosine schedule
    continues, and the best-loss bookkeeping carries over."""
    _from_jax_init(monkeypatch)
    cfg = dict(CFG, save_root=str(tmp_path))
    aug = AugmentConfig(**NO_AUG)
    T.train_model("ResNetUnet", *_port_loaders(), TrainConfig(**dict(cfg, epochs=1)), aug,
                  log=_quiet, device="cpu")
    logs = []
    res = T.train_model("ResNetUnet", *_port_loaders(), TrainConfig(**cfg), aug,
                        resume=True, log=logs.append, device="cpu")
    assert "Resumed ResNetUnet from epoch 1" in "\n".join(logs)
    assert [e[0] for e in _epochs(logs)] == [2]
    assert res.epochs_run == 2
    assert res.best_score == both_runs["tres"].best_score
    got = res.model.state_dict()
    for k, v in both_runs["tres"].model.state_dict().items():
        assert torch.equal(got[k], v), k
