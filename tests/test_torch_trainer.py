"""The port's two-stage trainer against the JAX package's: a 3-epoch run of
both from the same initial weights, the best checkpoint read by both eval
harnesses, resume, and reproducibility from a seed."""

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
from medseg_tpu.core.registry import get_model as jget_model
from medseg_tpu.data.loader import BatchLoader as JLoader
from medseg_tpu.data.synthetic import synthetic_cls as jsynthetic_cls
from medseg_tpu.eval import harness as JH
from medseg_tpu.models import resnet as jresnet
from medseg_tpu.train import steps as JS
from medseg_tpu.train import train_model as jtrain_model
from medseg_tpu_torch.core.config import AugmentConfig, EvalConfig, TrainConfig
from medseg_tpu_torch.core.registry import get_model
from medseg_tpu_torch.data.loader import BatchLoader
from medseg_tpu_torch.data.synthetic import synthetic_cls
from medseg_tpu_torch.eval import harness as H
from medseg_tpu_torch.interop.from_jax import resnet_classifier_state_dict
from medseg_tpu_torch.models import resnet as tresnet
from medseg_tpu_torch.train import steps as TS
from medseg_tpu_torch.train import trainer as T

torch.set_num_threads(1)

N_TRAIN, N_VAL, SIZE, BATCH, VBATCH, SEED = 16, 8, 32, 8, 4, 3
# float32; stage 2 at the small lr of the reference's recipe (1e-6 there),
# so the two frameworks' float32 differences stay small over the run
CFG = dict(epochs=3, stage1_epochs=1, stage1_lr=1e-3, lr=1e-5,
           compute_dtype="float32")
NO_AUG = dict(affine_p=0.0, hflip_p=0.0, brightness_contrast_p=0.0)
EPOCH_LINE = re.compile(r"\[ResNet18\] Ep(\d+): TrainLoss ([\d.]+) \(Acc ([\d.]+)%\) "
                        r"\| ValLoss ([\d.]+) \| ValAcc ([\d.]+)%")


def _port_loaders(shuffle=True):
    ds = synthetic_cls(N_TRAIN + N_VAL, SIZE)
    return (BatchLoader(ds, BATCH, shuffle=shuffle, seed=SEED,
                        indices=np.arange(N_TRAIN), device="cpu"),
            BatchLoader(ds, VBATCH, shuffle=False,
                        indices=np.arange(N_TRAIN, N_TRAIN + N_VAL), device="cpu"))


def _dropout0(monkeypatch):
    """Both trainers call the factory without cfg.dropout; dropout 0
    through each registry's factory."""
    monkeypatch.setitem(jget_model("ResNet18"), "factory",
                        functools.partial(jresnet.resnet18, dropout=0.0))
    monkeypatch.setitem(get_model("ResNet18"), "factory",
                        functools.partial(tresnet.resnet18, dropout=0.0))


def _jax_init(seed):
    """The JAX trainer's initial variables (medseg_tpu/train/trainer.py:
    186-191): flax's init from the second half of split(key(seed)); the
    parameters depend on the sample batch's shape only."""
    _, init_rng = jax.random.split(jax.random.key(seed))
    return jresnet.resnet18(dropout=0.0).init(
        {"params": init_rng, "dropout": init_rng}, jnp.zeros((1, SIZE, SIZE, 3)))


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
    """One 3-epoch run of each trainer: float32, augmentation off, dropout
    0, the same loaders' seed, both from the JAX init.  The port's run saves
    its checkpoints under a temporary root."""
    mp = pytest.MonkeyPatch()
    try:
        _dropout0(mp)
        jlrs, tlrs = [], []
        _recording(mp, JS, jlrs)
        _recording(mp, TS, tlrs)
        sd = resnet_classifier_state_dict(_jax_init(0), 18)
        mp.setattr(T, "init_weights", lambda model, gen: model.load_state_dict(sd))

        jds = jsynthetic_cls(N_TRAIN + N_VAL, SIZE)
        jlogs = []
        jres = jtrain_model(
            "ResNet18",
            JLoader(jds, BATCH, shuffle=True, seed=SEED, indices=np.arange(N_TRAIN)),
            JLoader(jds, VBATCH, shuffle=False,
                    indices=np.arange(N_TRAIN, N_TRAIN + N_VAL)),
            JTrainConfig(**CFG), JAugmentConfig(**NO_AUG), seed=0, save=False,
            log=jlogs.append)
        root = tmp_path_factory.mktemp("port_run")
        tlogs = []
        tres = T.train_model("ResNet18", *_port_loaders(),
                             TrainConfig(**CFG, save_root=str(root)),
                             AugmentConfig(**NO_AUG), seed=0, save=True,
                             log=tlogs.append, device="cpu")
    finally:
        mp.undo()
    return dict(jres=jres, jlogs=jlogs, jlrs=jlrs, tres=tres, tlogs=tlogs,
                tlrs=tlrs, root=root)


def _epochs(logs):
    return [tuple(float(v) for v in m.groups()) for m in map(EPOCH_LINE.match, logs) if m]


def test_three_epochs_match_jax(both_runs):
    """Same LR sequence (exactly), same stage lines, the same accuracies
    (counts of the same samples), losses within one unit of their printed
    third decimal (the float32 runs differ by ~1e-5), the same best score
    and epoch count."""
    r = both_runs
    assert r["tlrs"] == r["jlrs"] and len(r["tlrs"]) == 3
    assert r["tlrs"][:2] == [1e-3, 1e-5]
    other = lambda logs: [s for s in logs if not EPOCH_LINE.match(s)  # noqa: E731
                          and not s.startswith("Training for ResNet18 finished in")]
    assert other(r["tlogs"]) == other(r["jlogs"])
    assert any("STAGE 1" in s for s in r["tlogs"])
    assert any("STAGE 2" in s for s in r["tlogs"])
    got, want = _epochs(r["tlogs"]), _epochs(r["jlogs"])
    assert [e[0] for e in got] == [e[0] for e in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert (g[2], g[4]) == (w[2], w[4])  # train and val accuracy
        assert abs(g[1] - w[1]) <= 1.001e-3 and abs(g[3] - w[3]) <= 1.001e-3
    assert r["tres"].best_score == r["jres"].best_score > 0
    assert r["tres"].epochs_run == r["jres"].epochs_run == 3


def test_best_checkpoint_loads_in_both_harnesses(both_runs):
    """The port's ResNet18_best_acc.pt, read from disk by the JAX package's
    harness (.pt branch) and by the port's: equal metrics over the
    validation split, and the same predictions and logits (1e-4) on a
    batch."""
    weights = str(both_runs["root"])
    variables, _ = JH.load_model_bundle("ResNet18", weights, seg=False)
    sd, _ = H.load_model_bundle("ResNet18", weights, seg=False)
    model = tresnet.resnet18(device="cpu")
    model.load_state_dict(sd, strict=True)
    images = np.random.default_rng(0).normal(0, 1, (4, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jresnet.resnet18().apply(variables, jnp.asarray(images)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))

    jds = jsynthetic_cls(N_TRAIN + N_VAL, SIZE)
    jres = JH.evaluate_model(
        "ResNet18", JLoader(jds, VBATCH, shuffle=False,
                            indices=np.arange(N_TRAIN, N_TRAIN + N_VAL)),
        None, JEvalConfig(weights_root=weights), log=_quiet)
    tres = H.evaluate_model("ResNet18", _port_loaders()[1], None,
                            EvalConfig(weights_root=weights), log=_quiet, device="cpu")
    assert tres.keys() == jres.keys()
    for k in jres:
        np.testing.assert_array_equal(np.asarray(tres[k]), np.asarray(jres[k]), err_msg=k)


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        _dropout0(mp)
        res = T.train_model("ResNet18", *_port_loaders(shuffle=False),
                            TrainConfig(**CFG, save_root=str(tmp_path_factory.mktemp("u"))),
                            AugmentConfig(**NO_AUG), save=True, log=_quiet, device="cpu")
    finally:
        mp.undo()
    return _state(res.model)


@pytest.mark.parametrize("stop_after", [1, 2], ids=["stage_boundary", "mid_stage2"])
def test_resume_equals_uninterrupted_run(stop_after, uninterrupted, tmp_path,
                                         monkeypatch):
    """A run cut after epoch 1 (the stage boundary: the stage-2 optimizer
    starts fresh) or 2 (mid stage 2: AdamW's moments and step restored),
    resumed to epoch 3, ends with the uninterrupted run's parameters and
    statistics, bit for bit.  Augmentation and dropout are off and the
    loaders unshuffled, since a resumed run restarts its generators and
    loaders as the JAX trainer does (tests/test_resume_and_mesh.py:20-62)."""
    _dropout0(monkeypatch)
    cfg = dict(CFG, save_root=str(tmp_path))
    aug = AugmentConfig(**NO_AUG)
    T.train_model("ResNet18", *_port_loaders(shuffle=False),
                  TrainConfig(**dict(cfg, epochs=stop_after)), aug, log=_quiet,
                  device="cpu")
    logs = []
    res = T.train_model("ResNet18", *_port_loaders(shuffle=False), TrainConfig(**cfg),
                        aug, resume=True, log=logs.append, device="cpu")
    assert f"Resumed ResNet18 from epoch {stop_after}" in "\n".join(logs)
    assert ("stage 1->2 boundary" in "\n".join(logs)) == (stop_after == 1)
    assert not any("STAGE 1" in s for s in logs)
    assert [e[0] for e in _epochs(logs)] == list(range(stop_after + 1, 4))
    assert res.epochs_run == 3
    got = res.model.state_dict()
    for k, v in uninterrupted.items():
        assert torch.equal(got[k], v), k


def test_resume_rejects_another_model(tmp_path):
    from medseg_tpu_torch.train import checkpoint as ckpt

    model = tresnet.resnet18(device="cpu")
    cfg = TrainConfig(**CFG, save_root=str(tmp_path))
    ckpt.save_resume(str(cfg.cls_save_dir), "ResNet50", model,
                     TS.build_optimizer(1e-3, 5e-4, 1.0, model.fc.parameters()),
                     step=2, epoch=1, best_score=50.0, extra={"stage": 1})
    with pytest.raises(ValueError, match="does not match model"):
        T.train_model("ResNet50", *_port_loaders(), cfg, AugmentConfig(**NO_AUG),
                      resume=True, log=_quiet, device="cpu")


def test_same_seed_same_parameters(tmp_path):
    """Two CPU runs with augmentation and the head's dropout on and the same
    seed end bitwise equal; another seed differs.  The head trains with
    dropout 0.5 whatever TrainConfig.dropout says, as in the JAX trainer."""
    cfg = TrainConfig(**dict(CFG, epochs=2, dropout=0.1), save_root=str(tmp_path))
    runs = [T.train_model("ResNet18", *_port_loaders(), cfg, AugmentConfig(),
                          seed=seed, save=False, log=_quiet, device="cpu").model
            for seed in (7, 7, 8)]
    assert runs[0].fc[0].p == 0.5
    a, b, c = (m.state_dict() for m in runs)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])


def test_no_checkpoint_warning(tmp_path, monkeypatch):
    """A run whose validation accuracy stays 0 saves no best checkpoint and
    ends with the JAX trainer's warning."""
    real = TS.cls_eval_step

    def never_right(*args, **kw):
        loss_sum, correct, preds = real(*args, **kw)
        return loss_sum, correct * 0, preds

    monkeypatch.setattr(TS, "cls_eval_step", never_right)
    logs = []
    res = T.train_model("ResNet18", *_port_loaders(),
                        TrainConfig(**dict(CFG, epochs=1), save_root=str(tmp_path)),
                        AugmentConfig(), log=logs.append, device="cpu")
    assert res.best_score == 0.0
    assert logs[-1].startswith("[WARNING] ResNet18: validation accuracy never "
                               "exceeded 0%")
    names = sorted(p.name for p in (tmp_path / "classification_models").iterdir())
    assert names == ["ResNet18_resume.pt"]
