"""The port's scan_chunk (train/steps.scan_epoch, scan_epoch_driver) on the
CPU, where a chunk runs the same eager step K times: the card's CUDA graph
replays those steps, and chip_smoke.py's scan path holds the graph to them.

(a) epoch_index_batches against __iter__ (and the JAX loader's), per rank
under a group; (b) scan_epoch_driver's routing and generator use against the
per-step loop, with and without the card's warm-up step; (c) train_model
with scan_chunk 2 and 3 against 0, bit for bit; (d) against the JAX
trainer's scan_chunk=3; (e) both finetuners against the JAX finetuners'
scan_chunk=2; (f) two gloo ranks; (g) resumes across the two paths; and
the CLI's --scan-chunk, the optimizer's resume flags and the gloo refusal
on the card.  Models at full width on 32px data, CLIP and CLIPSeg the tiny
towers of tests/torch_clip_helpers.py.
"""

import functools
import re

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from medseg_tpu.core.config import AugmentConfig as JAugmentConfig
from medseg_tpu.core.config import CLIPFinetuneConfig as JCLIPCfg
from medseg_tpu.core.config import CLIPSegFinetuneConfig as JCLIPSegCfg
from medseg_tpu.core.config import TrainConfig as JTrainConfig
from medseg_tpu.core.registry import get_model as jget_model
from medseg_tpu.data.loader import BatchLoader as JLoader
from medseg_tpu.data.packed import PackedDataset as JPackedDataset
from medseg_tpu.data.synthetic import synthetic_cls as jsynthetic_cls
from medseg_tpu.data.synthetic import synthetic_seg as jsynthetic_seg
from medseg_tpu.models import resnet as jresnet
from medseg_tpu.train import clip_finetune as jclip_ft
from medseg_tpu.train import clipseg_finetune as jclipseg_ft
from medseg_tpu.train import train_model as jtrain_model
from medseg_tpu_torch.apps import cli
from medseg_tpu_torch.core.config import (AugmentConfig, CLIPFinetuneConfig,
                                          CLIPSegFinetuneConfig, TrainConfig)
from medseg_tpu_torch.core.registry import get_model
from medseg_tpu_torch.data.loader import BatchLoader
from medseg_tpu_torch.data.packed import PackedDataset, save_packed
from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg
from medseg_tpu_torch.interop.from_jax import resnet_classifier_state_dict
from medseg_tpu_torch.models import resnet as tresnet
from medseg_tpu_torch.parallel import DataParallelGroup
from medseg_tpu_torch.train import checkpoint as ckpt
from medseg_tpu_torch.train import steps as S
from medseg_tpu_torch.train import trainer as T
from medseg_tpu_torch.train.clip_finetune import finetune_clip
from medseg_tpu_torch.train.clipseg_finetune import finetune_clipseg
from tests import torch_dist_worker as W
from tests.test_torch_finetune import (CLIP_PX, LR, SEG_PX, _cond, _tf, clip_vars,
                                       port_clip, port_clipseg)
from tests.torch_clip_helpers import (CLIP_GRID, CLIPSEG_GRID, JTinyClassifier,
                                      JTinyCLIPSeg, tiny_clip_patched)
from tests.torch_clip_helpers import clipseg_variables as clipseg_vars

torch.set_num_threads(1)

SIZE = 32
NUMBER = re.compile(r"-?\d+\.\d+")


def _quiet(*_):
    pass


def _epoch_lines(logs):
    return [ln for ln in logs if re.match(r"\[\w+\] Ep\d", ln)]


# --- (a) the loader's epoch indices ------------------------------------------------

def _fake_group(rank: int, size: int = 2) -> DataParallelGroup:
    """A group's rank and size for the loader, which calls no collective."""
    return DataParallelGroup(object(), rank, size, "cpu")


@pytest.mark.parametrize("drop_last", [False, True], ids=["tail", "drop_last"])
@pytest.mark.parametrize("rank", [None, 0, 1], ids=["one", "rank0", "rank1"])
def test_epoch_index_batches_matches_iter(drop_last, rank):
    """Over two epochs, epoch_index_batches gathers exactly the batches one
    __iter__ pass yields (the shuffle consumed alike), and without a group
    the JAX loader's indices (medseg_tpu tests/test_scan_epoch.py:145-170);
    under a W=2 group each rank's rows of every global batch, as
    _batch_indices cuts them (11 samples in batches of 4: two full, a
    ragged 3 padded to 4 by pad_to_multiple=2)."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (11, 4, 4, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (11,), dtype=np.int64)
    ds = PackedDataset(images=images, labels=labels, masks=None)
    group = None if rank is None else _fake_group(rank)
    pad = None if rank is None else 2

    def loader():
        return BatchLoader(ds, 4, shuffle=True, seed=3, drop_last=drop_last,
                           pad_to_multiple=pad, device="cpu", group=group)

    a, b = loader(), loader()
    jb = JLoader(JPackedDataset(images=images, labels=labels, masks=None), 4, shuffle=True,
                 seed=3, drop_last=drop_last)
    for _ in range(2):
        got_iter = [img.numpy() for img, _ in a]
        full, tail = b.epoch_index_batches()
        assert full.dtype == np.int64 and full.shape == (2, 4 if group is None else 2)
        got_idx = [images[row] for row in full] + ([] if tail is None else [images[tail]])
        assert len(got_iter) == len(got_idx) == (2 if drop_last else 3)
        for x, y in zip(got_iter, got_idx):
            np.testing.assert_array_equal(x, y)
        assert (tail is None) == drop_last
        if group is None:
            jfull, jtail = jb.epoch_index_batches()
            np.testing.assert_array_equal(full, jfull)
            assert (jtail is None) == (tail is None)
            if tail is not None:
                np.testing.assert_array_equal(tail, jtail)
        elif tail is not None:
            assert len(tail) == 2  # the tail of 3 padded to 4, this rank's half


# --- (b) scan_epoch_driver's routing -----------------------------------------------

class _CardRouting(S.ScanDrive):
    """A CPU drive that asks for the card's warm-up step before its chunks."""

    def warmup_steps(self) -> int:
        return 1


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card_routing"])
@pytest.mark.parametrize("k", [2, 3])
def test_driver_routing_matches_per_step_loop(k, card):
    """4 full batches of 4 and a ragged 2 (18 samples): scan_epoch_driver feeds
    the body the per-step loop's rows in its order, and the body's draws
    leave the generator where the loop leaves it.  Routing, as JAX's
    scan_epoch_driver: K=2 two chunks then the tail; K=3 one chunk, one
    remainder step, the tail; with the card's warm-up step first, the
    chunks start at the second batch (K=2: warm-up, one chunk, one
    remainder, tail; K=3: warm-up, one chunk, tail)."""
    images = np.arange(18, dtype=np.uint8).reshape(18, 1, 1, 1).repeat(3, -1)
    ds = PackedDataset(images=np.ascontiguousarray(images), labels=np.zeros(18, np.int64),
                       masks=None)

    def loader():
        return BatchLoader(ds, 4, shuffle=True, seed=7, device_cache=True, device="cpu")

    def run(per_step):
        gen = torch.Generator().manual_seed(5)
        seen, routes = [], []

        def body(x, _):
            seen.append(x[:, 0, 0, 0].tolist())
            torch.rand(x.shape[0], generator=gen)

        ld = loader()
        if per_step:
            for x, y in ld:
                body(x, y)
        else:
            drive = (_CardRouting if card else S.ScanDrive)(body, k, torch.device("cpu"))

            def on_step(x, y):
                routes.append("step")
                body(x, y)

            S.scan_epoch_driver(ld, drive, lambda n, b: routes.append(f"chunk{n}x{b}"),
                                on_step)
        return seen, gen.get_state(), routes

    want_rows, want_gen, _ = run(True)
    rows, gen_state, routes = run(False)
    assert rows == want_rows and len(rows) == 5
    assert torch.equal(gen_state, want_gen)
    expect = {(2, False): ["chunk2x4", "chunk2x4", "step"],
              (3, False): ["chunk3x4", "step", "step"],
              (2, True): ["step", "chunk2x4", "step", "step"],
              (3, True): ["step", "chunk3x4", "step"]}[(k, card)]
    assert routes == expect


# --- (c) train_model with and without scan_chunk -----------------------------------

def _run_port(name, ds, scan_chunk, root, aug=AugmentConfig(), epochs=2, shuffle=True,
              batch=4, n_train=18, resume=False):
    """train_model on n_train samples in batches of `batch` from the device
    cache and one validation batch; returns (epoch lines, final state, the
    resume checkpoint's step)."""
    n_val = 4
    tr = BatchLoader(ds, batch, shuffle=shuffle, seed=5, device_cache=True,
                     indices=np.arange(n_train), device="cpu")
    va = BatchLoader(ds, n_val, shuffle=False, indices=np.arange(n_train, n_train + n_val),
                     device="cpu")
    cfg = TrainConfig(epochs=epochs, stage1_epochs=1, lr=1e-4, stage1_lr=1e-3,
                      compute_dtype="float32", save_root=str(root))
    logs = []
    res = T.train_model(name, tr, va, cfg, aug, seed=11, save=True, resume=resume,
                        log=logs.append, device="cpu", scan_chunk=scan_chunk)
    seg = get_model(name)["task"] == "segmentation"
    resume_pt = (cfg.seg_save_dir if seg else cfg.cls_save_dir) / f"{name}_resume.pt"
    step = torch.load(resume_pt, weights_only=False)["step"]
    return _epoch_lines(logs), res.model.state_dict(), step


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Per model: train_model with scan_chunk 0, 2 and 3 (18 samples: 4 full
    batches and a ragged 2; augmentation and the head's dropout on), for
    2 epochs (ResNet18: the stage switch) or 1 (AttentionUNet, whose CPU
    steps take ~2 s)."""
    out = {}
    for name, make, epochs in (("ResNet18", synthetic_cls, 2),
                               ("AttentionUNet", synthetic_seg, 1)):
        ds = make(n=22, img_size=SIZE, seed=1)
        for k in (0, 2, 3):
            out[name, k] = _run_port(name, ds, k, tmp_path_factory.mktemp(f"{name}{k}"),
                                     epochs=epochs)
    return out


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", ["ResNet18", "AttentionUNet"])
def test_train_model_scan_chunk_equals_per_step(port_runs, name, k):
    """Bit for bit: the epoch lines, every tensor of the final state and the
    resume checkpoint's step (5 steps an epoch).  ResNet18 crosses the
    stage switch; both draw augmentation (and ResNet18 its head's dropout)
    from the trainer's generator."""
    lines0, state0, step0 = port_runs[name, 0]
    lines, state, step = port_runs[name, k]
    epochs = 2 if name == "ResNet18" else 1
    assert lines == lines0 and len(lines) == epochs
    assert step == step0 == 5 * epochs
    for key, v in state0.items():
        assert torch.equal(state[key], v), key


# --- (d) against the JAX trainer's scan_chunk --------------------------------------

def _dropout0(mp):
    mp.setitem(jget_model("ResNet18"), "factory", functools.partial(jresnet.resnet18,
                                                                     dropout=0.0))
    mp.setitem(get_model("ResNet18"), "factory", functools.partial(tresnet.resnet18,
                                                                    dropout=0.0))


def test_train_model_scan_chunk_matches_jax(tmp_path, monkeypatch):
    """scan_chunk=3 in both trainers, 2 epochs (the stage switch), 16 train
    samples in batches of 4 (one chunk of 3 and a remainder step), float32,
    augmentation off and dropout 0, from the JAX init: the same log lines
    but the epoch lines, the same accuracies, losses within one unit of
    their printed third decimal (tests/test_torch_trainer.py's tolerance:
    the float32 runs differ by ~1e-5), the same best score."""
    _dropout0(monkeypatch)
    _, init_rng = jax.random.split(jax.random.key(0))
    sd = resnet_classifier_state_dict(jresnet.resnet18(dropout=0.0).init(
        {"params": init_rng, "dropout": init_rng}, np.zeros((1, SIZE, SIZE, 3), np.float32)),
        18)
    monkeypatch.setattr(T, "init_weights", lambda model, gen: model.load_state_dict(sd))
    cfg = dict(epochs=2, stage1_epochs=1, stage1_lr=1e-3, lr=1e-5, compute_dtype="float32")
    no_aug = dict(affine_p=0.0, hflip_p=0.0, brightness_contrast_p=0.0)
    jds = jsynthetic_cls(24, SIZE)
    jlogs = []
    jres = jtrain_model(
        "ResNet18", JLoader(jds, 4, shuffle=True, seed=3, indices=np.arange(16),
                            device_cache=True),
        JLoader(jds, 4, shuffle=False, indices=np.arange(16, 24)),
        JTrainConfig(**cfg), JAugmentConfig(**no_aug), seed=0, save=False,
        log=jlogs.append, scan_chunk=3)
    ds = synthetic_cls(24, SIZE)
    tlogs = []
    tres = T.train_model(
        "ResNet18", BatchLoader(ds, 4, shuffle=True, seed=3, indices=np.arange(16),
                                device_cache=True, device="cpu"),
        BatchLoader(ds, 4, shuffle=False, indices=np.arange(16, 24), device="cpu"),
        TrainConfig(**cfg, save_root=str(tmp_path)), AugmentConfig(**no_aug), seed=0,
        save=False, log=tlogs.append, device="cpu", scan_chunk=3)
    other = lambda logs: [s for s in logs if not re.match(r"\[ResNet18\] Ep", s)  # noqa: E731
                          and not s.startswith("Training for ResNet18 finished in")]
    assert other(tlogs) == other(jlogs)
    got, want = _epoch_lines(tlogs), _epoch_lines(jlogs)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        gn, wn = (np.array([float(v) for v in NUMBER.findall(s)]) for s in (g, w))
        assert gn[[1, 3]].tolist() == wn[[1, 3]].tolist()  # the accuracies
        np.testing.assert_allclose(gn, wn, rtol=0, atol=1.001e-3)
    assert tres.best_score == jres.best_score


# --- (e) the finetuners against the JAX finetuners' scan_chunk ----------------------

def test_finetune_clip_scan_chunk_matches_jax(tmp_path, monkeypatch):
    """scan_chunk=2 in both finetune_clip, 2 epochs on 14 train samples in
    batches of 4 (a chunk of 2, a remainder step, a ragged 2) and 5
    validation ones: the epoch lines within 1e-3 as logged
    (tests/test_torch_finetune.py's tolerance), the same best accuracy; and
    the port's run equal bit for bit to its own per-step run."""
    monkeypatch.setattr(jclip_ft.ckpt, "save_best", lambda *a, **k: None)
    jds = jsynthetic_cls(n=19, img_size=CLIP_PX, seed=2)
    ds = synthetic_cls(n=19, img_size=CLIP_PX, seed=2)
    tr, va = np.arange(14), np.arange(14, 19)
    jlogs = []
    jbest = jclip_ft.finetune_clip(
        JLoader(jds, 4, shuffle=True, seed=3, indices=tr, device_cache=True),
        JLoader(jds, 4, shuffle=False, indices=va), clip_vars(), _tf(),
        JCLIPCfg(save_root=str(tmp_path / "jax"), epochs=2, lr=LR), model=JTinyClassifier(),
        image_size=CLIP_GRID, scan_chunk=2, log=jlogs.append)
    runs = {}
    for k in (0, 2):
        logs = []
        model = port_clip()
        best = finetune_clip(
            BatchLoader(ds, 4, shuffle=True, seed=3, indices=tr, device_cache=True,
                        device="cpu"),
            BatchLoader(ds, 4, shuffle=False, indices=va, device="cpu"), model, _tf(),
            CLIPFinetuneConfig(save_root=str(tmp_path / f"k{k}"), epochs=2, lr=LR),
            image_size=CLIP_GRID, log=logs.append, device="cpu", scan_chunk=k)
        runs[k] = (best, _epoch_lines(logs), model.state_dict())
    best, lines, state = runs[2]
    assert best == jbest and lines == runs[0][1] and len(lines) == 2
    assert all(torch.equal(v, runs[0][2][key]) for key, v in state.items())
    for g, w in zip(lines, _epoch_lines(jlogs)):
        np.testing.assert_allclose([float(v) for v in NUMBER.findall(g)],
                                   [float(v) for v in NUMBER.findall(w)], rtol=0, atol=1.01e-3)


def test_finetune_clipseg_scan_chunk_matches_jax(tmp_path, monkeypatch):
    """scan_chunk=2 in both finetune_clipseg, 2 epochs on 11 train samples
    in batches of 4 (one chunk of 2, then the ragged 3 as the padded masked
    step) and 5 validation ones: the epoch lines within 1e-3 as logged, the
    best dice within 1e-6 (tests/test_torch_finetune.py's tolerances); the
    port's run bit for bit its per-step run."""
    monkeypatch.setattr(jclipseg_ft.ckpt, "save_best", lambda *a, **k: None)
    jds = jsynthetic_seg(n=16, img_size=SEG_PX, seed=4)
    ds = synthetic_seg(n=16, img_size=SEG_PX, seed=4)
    tr, va = np.arange(11), np.arange(11, 16)
    jlogs = []
    jbest = jclipseg_ft.finetune_clipseg(
        JLoader(jds, 4, shuffle=True, seed=3, indices=tr, device_cache=True),
        JLoader(jds, 4, shuffle=False, indices=va), clipseg_vars(), _cond(),
        JCLIPSegCfg(save_root=str(tmp_path / "jax"), epochs=2, lr=LR), model=JTinyCLIPSeg(),
        image_size=CLIPSEG_GRID, scan_chunk=2, log=jlogs.append)
    runs = {}
    for k in (0, 2):
        logs = []
        model = port_clipseg()
        best = finetune_clipseg(
            BatchLoader(ds, 4, shuffle=True, seed=3, indices=tr, device_cache=True,
                        device="cpu"),
            BatchLoader(ds, 4, shuffle=False, indices=va, device="cpu"), model, _cond(),
            CLIPSegFinetuneConfig(save_root=str(tmp_path / f"k{k}"), epochs=2, lr=LR),
            image_size=CLIPSEG_GRID, log=logs.append, device="cpu", scan_chunk=k)
        runs[k] = (best, _epoch_lines(logs), model.state_dict())
    best, lines, state = runs[2]
    assert best == runs[0][0] and lines == runs[0][1] and len(lines) == 2
    assert all(torch.equal(v, runs[0][2][key]) for key, v in state.items())
    assert best == pytest.approx(jbest, abs=1e-6)
    for g, w in zip(lines, _epoch_lines(jlogs)):
        np.testing.assert_allclose([float(v) for v in NUMBER.findall(g)],
                                   [float(v) for v in NUMBER.findall(w)], rtol=0, atol=1.01e-3)


# --- (f) two gloo ranks --------------------------------------------------------------

def test_two_ranks_scan_chunk_equals_per_step(tmp_path):
    """Two gloo ranks on the CPU (tests/torch_dist_worker.py case "scan"):
    train_model("ResNet18") float32 with scan_chunk=2 against per-step in
    each rank (3 steps an epoch: a chunk and a remainder step), bit for
    bit: the epoch lines and the final state; both ranks log alike."""
    with W.spawn_ranks(tmp_path, ["scan"]) as collect:
        ranks = collect()["scan"]
    for r in ranks:
        assert r["scan"]["logs"] == r["step"]["logs"] and len(r["step"]["logs"]) == 2
        for key, v in r["step"]["state"].items():
            assert torch.equal(r["scan"]["state"][key], v), key
    assert ranks[0]["scan"]["logs"] == ranks[1]["scan"]["logs"]


# --- (g) resumes across the two paths ------------------------------------------------

@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        _dropout0(mp)
        return _run_port("ResNet18", synthetic_cls(n=12, img_size=SIZE, seed=2), 0,
                         tmp_path_factory.mktemp("u"), aug=AugmentConfig(**_NO_AUG),
                         epochs=3, shuffle=False, n_train=8)
    finally:
        mp.undo()


_NO_AUG = dict(affine_p=0.0, hflip_p=0.0, brightness_contrast_p=0.0)


@pytest.mark.parametrize("first,then", [(2, 0), (0, 2)], ids=["scan_then_step",
                                                              "step_then_scan"])
def test_resume_across_scan_and_per_step(first, then, uninterrupted, tmp_path, monkeypatch):
    """A run cut after epoch 2 with scan_chunk `first` and resumed to epoch
    3 with `then` ends bit for bit where the uninterrupted per-step run
    does, with its resume step (6: two steps an epoch, one chunk of 2
    with scan_chunk); augmentation and dropout off and the
    loaders unshuffled, as a resumed run restarts them
    (tests/test_torch_trainer.py)."""
    _dropout0(monkeypatch)
    ds = synthetic_cls(n=12, img_size=SIZE, seed=2)
    kw = dict(aug=AugmentConfig(**_NO_AUG), shuffle=False, n_train=8)
    _run_port("ResNet18", ds, first, tmp_path, epochs=2, **kw)
    lines, state, step = _run_port("ResNet18", ds, then, tmp_path, epochs=3, resume=True, **kw)
    want_lines, want_state, want_step = uninterrupted
    assert lines == want_lines[2:] and step == want_step == 6
    for key, v in want_state.items():
        assert torch.equal(state[key], v), key


def test_optimizer_keeps_its_flags_on_resume():
    """A state written by the card's optimizer (fused, capturable, float32
    step counts) loads into the CPU's with the CPU's flags, and the next
    step equals the one after loading the CPU's own state."""
    torch.manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(5, 3)) for _ in range(2)]

    def opt():
        return S.build_optimizer(1e-2, 5e-4, 1.0, [torch.nn.Parameter(p.detach().clone())
                                                   for p in params])

    src = opt()
    for p in src.param_groups[0]["params"]:
        p.grad = torch.ones_like(p)
    src.step()
    state = src.state_dict()
    card = {"state": state["state"], "param_groups": [
        dict(g, fused=True, capturable=True) for g in state["param_groups"]]}
    results = []
    for sd in (state, card):
        o = opt()
        o.load_state_dict(sd)
        assert [(g["fused"], g["capturable"]) for g in o.param_groups] == [(None, False)]
        for p, q in zip(o.param_groups[0]["params"], src.param_groups[0]["params"]):
            p.data.copy_(q.data)
            p.grad = torch.full_like(p, 0.5)
        o.step()
        results.append([p.detach().clone() for p in o.param_groups[0]["params"]])
    assert all(torch.equal(a, b) for a, b in zip(*results))
    # a fused optimizer (the card's flags, here on the CPU) takes the step
    # counts as float32 tensors on the parameters' device
    o = opt()
    o.param_groups[0]["fused"] = True
    o.load_state_dict(state)
    assert (o.param_groups[0]["fused"], o.param_groups[0]["capturable"]) == (True, False)
    for st in o.state.values():
        assert st["step"].dtype == torch.float32 and st["step"].device.type == "cpu"


def test_scan_epoch_refuses_gloo_on_the_card(tmp_path):
    """Under a joined gloo group, a drive for the card raises before any
    capture (a graph holds NCCL's collectives only); on the CPU gloo is
    fine.  scan_chunk below 2 is not a chunk."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        group = DataParallelGroup(dist.group.WORLD, 0, 1, "cpu")
        with pytest.raises(ValueError, match="under a gloo group on the card"):
            S.scan_epoch(_quiet, 2, "cuda", group=group)
        assert S.scan_epoch(_quiet, 2, "cpu", group=group).warmup_steps() == 0
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="at least 2"):
        S.scan_epoch(_quiet, 1, "cpu")


def test_scan_chunk_without_device_cache_logs_and_runs_per_step(tmp_path):
    """The JAX trainer's line when the loader keeps no device cache, and
    the per-step run's result."""
    ds = synthetic_cls(n=12, img_size=SIZE, seed=3)
    runs = []
    for k in (0, 2):
        logs = []
        res = T.train_model(
            "ResNet18", BatchLoader(ds, 4, shuffle=True, indices=np.arange(8), device="cpu"),
            BatchLoader(ds, 4, shuffle=False, indices=np.arange(8, 12), device="cpu"),
            TrainConfig(epochs=1, compute_dtype="float32", save_root=str(tmp_path)),
            save=False, log=logs.append, device="cpu", scan_chunk=k)
        runs.append((logs, res.model.state_dict()))
    assert ("[scan_chunk] disabled: requires device_cache (device_cache=False)"
            in runs[1][0])
    assert _epoch_lines(runs[1][0]) == _epoch_lines(runs[0][0])
    assert all(torch.equal(v, runs[0][1][k]) for k, v in runs[1][1].items())


# --- the CLI ---------------------------------------------------------------------------

def test_cli_scan_chunk_on_the_cpu(tmp_path, capsys):
    """`train ResNet18 --scan-chunk 2 --device cpu` writes the resume
    checkpoint that the command without it writes, bit for bit; so do
    `finetune-clip` and `finetune-clipseg --random-init --scan-chunk 2`
    with the tiny towers (their best checkpoints)."""
    packed = tmp_path / "packed"
    save_packed(synthetic_cls(n=24, img_size=SIZE, seed=0), str(packed), "train_cls")
    save_packed(synthetic_cls(n=20, img_size=40, seed=0), str(tmp_path / "clip"), "train_cls")
    save_packed(synthetic_seg(n=14, img_size=20, seed=1), str(tmp_path / "clip"), "train_seg")
    got = {}
    for k in ("0", "2"):
        w = tmp_path / f"w{k}"
        common = ["--weights-root", str(w), "--device", "cpu", "--scan-chunk", k,
                  "--epochs", "1", "--batch-size", "4"]
        cli.main(["train", "ResNet18", "--cache-dir", str(packed), "--dtype", "float32"]
                 + common)
        with tiny_clip_patched(tmp_path):
            for cmd in ("finetune-clip", "finetune-clipseg"):
                cli.main([cmd, "--random-init", "--cache-dir", str(tmp_path / "clip")]
                         + common)
        got[k] = {p.name: torch.load(p, weights_only=False) for p in sorted(w.rglob("*.pt"))}
    assert "[ResNet18] Ep1:" in capsys.readouterr().out
    assert sorted(got["2"]) == sorted(got["0"]) == [
        "CLIPSeg_best_loss.pt", "CLIP_best_acc.pt", "ResNet18_resume.pt"]
    for name, want in got["0"].items():
        have = got["2"][name]
        model = want["model"] if "model" in want else want
        for key, v in model.items():
            assert torch.equal((have["model"] if "model" in have else have)[key], v), (name, key)
    assert got["2"]["ResNet18_resume.pt"]["step"] == got["0"]["ResNet18_resume.pt"]["step"]
