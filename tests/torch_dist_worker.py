"""One rank of the port's data-parallel CPU tests (not collected by pytest).

    python tests/torch_dist_worker.py STORE WORLD RANK WORKDIR CASE[,CASE...]

joins a gloo group of WORLD processes through the file store STORE (as
MEDSEG_COORDINATOR=file://STORE, parallel/dist.initialize_from_env), runs
each case on its rows and writes WORKDIR/{case}.rank{RANK}.pt.  The tests
(tests/test_torch_parallel.py, tests/test_torch_dp_train.py) call the same
case functions in their own process with a world-1 group for the one-process
reference, and `spawn_ranks` spawns the ranks.  Weights a case needs from the
JAX package are written into WORKDIR by the test before the spawn; every
input is drawn from a numpy seed, the global batch on every rank.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch import nn

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # run as a script from the repo root
    sys.path.insert(0, str(ROOT))

from medseg_tpu_torch.nn.blocks import BatchNorm2d, Conv2d  # noqa: E402
from medseg_tpu_torch.parallel import (DataParallelGroup, data_parallel,  # noqa: E402
                                       shard_batch)

WORLD1 = DataParallelGroup(None, 0, 1, "cpu")  # the one-process reference
IMG = 32
DTYPES = {"f64": torch.float64, "f32": torch.float32}


@contextlib.contextmanager
def spawn_ranks(tmp: Path, cases, world: int = 2, timeout: float = 300.0):
    """Spawn `world` ranks running `cases` in `tmp`; yields collect(), which
    waits for them and returns {case: [rank 0's result, rank 1's, ...]}.
    Every rank is killed on the way out."""
    store = tmp / f"store-{'-'.join(cases)}"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__)), str(store), str(world), str(r), str(tmp),
         ",".join(cases)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]

    def collect() -> dict:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-6000:]}"
        return {c: [torch.load(tmp / f"{c}.rank{r}.pt", weights_only=False)
                    for r in range(world)] for c in cases}

    try:
        yield collect
    finally:
        for p in procs:
            p.kill()
            p.wait()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# --- models ---------------------------------------------------------------

def conv_bn(dtype, stride: int = 1) -> nn.Sequential:
    """flax ConvBN(8, kernel=3, stride): Conv3x3 with bias + BN + ReLU."""
    return nn.Sequential(Conv2d(3, 8, 3, stride, 1, compute_dtype=dtype),
                         BatchNorm2d(8, compute_dtype=dtype), nn.ReLU())


class TinyMLP(nn.Module):
    """tests/test_spmd.py's TinyMLP: flatten NHWC, Dense(32), ReLU, Dense(3)."""

    def __init__(self, inputs: int = 8 * 8 * 3):
        super().__init__()
        self.Dense_0 = nn.Linear(inputs, 32)
        self.Dense_1 = nn.Linear(32, 3)

    def forward(self, x, generator=None):
        return self.Dense_1(torch.relu(self.Dense_0(x.reshape(x.shape[0], -1))))


class TinyNet(nn.Module):
    """tests/dist_case.py's TinyNet: ConvBN(8, stride 2), mean over H and W,
    Dense(3); NHWC in."""

    def __init__(self):
        super().__init__()
        self.ConvBN_0 = conv_bn(torch.float32, stride=2)
        self.Dense_0 = nn.Linear(8, 3)

    def forward(self, x, generator=None):
        return self.Dense_0(self.ConvBN_0(x.permute(0, 3, 1, 2)).mean((2, 3)))


def _load(model: nn.Module, work: Path, name: str, dtype) -> nn.Module:
    model.load_state_dict(torch.load(work / f"{name}.weights.pt"), strict=True)
    return model.to(dtype)


# --- data -----------------------------------------------------------------

def bn_inputs():
    rng = np.random.default_rng(1)
    return (rng.normal(0.5, 2.0, (8, 8, 8, 3)), rng.normal(0, 1, (8, 8, 8, 8)))


def cls_batch(step: int, b: int = 8, size: int = IMG):
    rng = np.random.default_rng(20 + step)
    return (rng.normal(0, 1, (b, size, size, 3)).astype(np.float32),
            rng.integers(0, 3, b).astype(np.int32))


def small_batch(b: int = 16):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((b, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 3, b).astype(np.int32))


def summary(t: torch.Tensor) -> torch.Tensor:
    """[sum, sum of squares, dot with cos(0, 1, 2, ...)] of a tensor in
    float64: what a comparison at 1e-9 needs of a large one, in 24 bytes."""
    v = t.detach().double().reshape(-1)
    return torch.stack([v.sum(), v.square().sum(),
                        v @ torch.cos(torch.arange(v.numel(), dtype=torch.float64))])


def _params(model: nn.Module) -> dict:
    out = {f"param/{k}": v.detach().clone() for k, v in model.named_parameters()}
    out.update({f"buffer/{k}": v.detach().clone() for k, v in model.named_buffers()
                if k.endswith(("running_mean", "running_var"))})
    return out


# --- cases (each: group, workdir -> dict) ---------------------------------

def case_bn(group: DataParallelGroup, work: Path) -> dict:
    """A train-mode ConvBN on this rank's rows of a global batch of 8:
    its output, the input and parameter gradients of sum(y * ct) (the
    parameter ones this rank's share), and the running statistics."""
    x, ct = bn_inputs()
    out = {}
    for tag, dtype in DTYPES.items():
        model = _load(conv_bn(dtype), work, "bn", dtype).train()
        xl = shard_batch(nchw(x).to(dtype), group).requires_grad_(True)
        with data_parallel(group):
            y = model(xl)
            (y * shard_batch(nchw(ct).to(dtype), group)).sum().backward()
        out[tag] = {"y": nhwc(y), "dx": nhwc(xl.grad),
                    **{k: v.numpy() for k, v in _params(model).items()},
                    **{f"grad/{k}": p.grad.numpy() for k, p in model.named_parameters()}}
    return out


def cls_steps(group, work: Path, dtype, steps: int = 2, use_group: bool = True) -> dict:
    """`steps` stage-2 steps of ResNet18 (dropout 0, lr 1e-5, clip 1.0,
    which fires) on this rank's rows of global batches of 8 at 32px:
    each step's loss and correct count, step 1's clipped gradients, and
    the parameters and running statistics after the last."""
    from medseg_tpu_torch.models.resnet import resnet18
    from medseg_tpu_torch.train import steps as S

    model = _load(resnet18(dtype=dtype, device="cpu", dropout=0.0), work, "cls", dtype)
    model.train()
    opt = S.build_optimizer(1e-5, 5e-4, 1.0, list(model.parameters()))
    gen = torch.Generator().manual_seed(0)
    out = {"loss": [], "correct": []}
    for i in range(steps):
        x, y = cls_batch(i)
        with data_parallel(group if use_group else None):
            loss, correct = S.cls_train_step(model, opt, shard_batch(x, group).to(dtype),
                                             shard_batch(y, group), gen, 0.1)
        out["loss"].append(loss.item())
        out["correct"].append(correct.item())
        if i == 0:
            out["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    out.update(_params(model))
    return out


def case_cls(group, work: Path) -> dict:
    return {tag: cls_steps(group, work, dtype) for tag, dtype in DTYPES.items()}


def case_explicit(group, work: Path) -> dict:
    """make_cls_train_step_explicit, one step, on TinyMLP and TinyNet (a
    global batch of 16 at 8x8, lr 1e-2, weight decay 1e-4)."""
    from medseg_tpu_torch.parallel.spmd import make_cls_train_step_explicit
    from medseg_tpu_torch.train import steps as S

    x, y = small_batch()
    out = {}
    for name, model in (("mlp", TinyMLP()), ("convbn", TinyNet())):
        model = _load(model, work, name, torch.float32).train()
        opt = S.build_optimizer(1e-2, 1e-4, 1.0, list(model.parameters()))
        step = make_cls_train_step_explicit(model, opt, group)
        loss, correct = step(shard_batch(x, group), shard_batch(y, group),
                             torch.Generator().manual_seed(0))
        out[name] = {"loss": loss.item(), "correct": correct.item(), **_params(model)}
    return out


def sharded_eval(group, work: Path, name: str) -> dict:
    """evaluate_model(mesh=group) over 13 samples in batches of 8 (a
    ragged tail of 5) at 32px; the caller's loader must come back
    untouched."""
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.synthetic import synthetic_cls, synthetic_seg
    from medseg_tpu_torch.eval.harness import evaluate_model

    seg = name != "ResNet18"
    ds = (synthetic_seg if seg else synthetic_cls)(n=13, img_size=IMG)
    loader = BatchLoader(ds, 8, shuffle=False, device="cpu")
    res = evaluate_model(name, loader, torch.load(work / f"{name}.weights.pt"),
                         log=lambda *_: None, mesh=group, device="cpu")
    assert loader.group is None and loader.pad_to_multiple is None
    return {k: np.asarray(v) for k, v in res.items()}


def case_eval(group, work: Path) -> dict:
    return {name: sharded_eval(group, work, name) for name in ("ResNet18", "AttentionUNet")}


def case_seg(group, work: Path) -> dict:
    """One float64 step of ResNetUnet (the encoder frozen, its BatchNorms
    training on global statistics) at 32px on this rank's rows of a global
    batch of 4, the augmentation (mask as a 4th plane, the CPU branch)
    drawn for the global batch: the loss, the decoder's clipped gradients,
    every parameter and running statistic after the step, each as its
    summary() (95M float64 parameters)."""
    from medseg_tpu_torch.core.config import AugmentConfig
    from medseg_tpu_torch.data.synthetic import synthetic_seg
    from medseg_tpu_torch.models.resnet_unet import resnet_unet
    from medseg_tpu_torch.ops.augment import augment_batch
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable

    dtype = torch.float64
    torch.manual_seed(0)  # the factory's own init, the same in every process
    model = resnet_unet(dtype=dtype, device="cpu").to(dtype).train()
    opt = S.build_optimizer(1e-4, 5e-4, 1.0,
                            set_trainable(model, finetune_filter("ResNetUnet")))
    ds = synthetic_seg(n=4, img_size=IMG, seed=2)
    images, masks = (shard_batch(a, group) for a in (ds.images, ds.masks))
    with data_parallel(group):
        loss = S.seg_train_step(
            model, opt, images, masks, torch.Generator().manual_seed(1),
            prep=lambda g, x, m: augment_batch(g, x, m, cfg=AugmentConfig(), out_dtype=dtype))
    out = {k: summary(v) for k, v in _params(model).items()}
    out.update({f"grad/{k}": summary(p.grad) for k, p in model.named_parameters()
                if p.grad is not None})
    return {"loss": loss.item(), **out}


def case_trainer(group, work: Path) -> dict:
    """train_model("ResNet18") float32 at 32px over the group: 14 train
    samples in batches of 4 (3 steps an epoch, the tail of 2 dropped) and 5
    validation ones (4 + a ragged 1), 2 epochs with the stage switch after
    the first (the recipe's stage-2 lr, 1e-6), the head's dropout and the
    augmentation drawn for the global batch.  Returns the log lines, the best score, the final state
    and the files each rank wrote (rank 0's alone under a group)."""
    from medseg_tpu_torch.core.config import TrainConfig
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.synthetic import synthetic_cls
    from medseg_tpu_torch.train import checkpoint as ckpt
    from medseg_tpu_torch.train.trainer import train_model

    ds = synthetic_cls(n=19, img_size=IMG, seed=6)
    train = BatchLoader(ds, 4, shuffle=True, seed=2, indices=np.arange(14), device="cpu")
    val = BatchLoader(ds, 4, shuffle=False, indices=np.arange(14, 19), device="cpu")
    saved, save = [], ckpt.torch.save

    def recording_save(obj, path, *a, **kw):
        saved.append(Path(path).name)
        return save(obj, path, *a, **kw)

    ckpt.torch.save = recording_save
    logs = []
    try:
        cfg = TrainConfig(epochs=2, stage1_epochs=1, lr=1e-6, stage1_lr=1e-3,
                          compute_dtype="float32",
                          save_root=str(work / f"trainer-w{group.size}"))
        res = train_model("ResNet18", train, val, cfg, log=logs.append, device="cpu",
                          mesh=group)
    finally:
        ckpt.torch.save = save
    assert (train.group, train.drop_last, val.pad_to_multiple) == (None, False, None)
    return {"logs": logs, "best": res.best_score, "saved": saved, **_params(res.model)}


def tiny_clipseg():
    """The tiny CLIPSeg of tests/torch_clip_helpers.py, seeded."""
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.models.clipseg import CLIPSegModel
    from medseg_tpu_torch.nn.vit import TowerConfig

    vision = TowerConfig(hidden_size=40, num_layers=2, num_heads=2, intermediate_size=80,
                         image_size=32, patch_size=8)
    text = TowerConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                       vocab_size=100, max_positions=16, eos_token_id=99)
    model = CLIPSegModel(vision, text, 24, extract_layers=(0, 1), reduce_dim=16,
                         decoder_heads=2, decoder_intermediate=32)
    return get_model("CLIPSeg")["init_weights"](model, torch.Generator().manual_seed(3))


CLIPSEG_GRID = 48


def case_clipseg(group, work: Path) -> dict:
    """The tiny CLIPSeg: one float32 decoder step on this rank's rows of a
    global batch of 4 at 20px (the dice's sums reduced over the group),
    its loss and clipped gradients; and finetune_clipseg float32 for one
    epoch (8 train samples in batches of 4, 5 validation ones: 4 + a
    ragged 1), its log lines and best dice."""
    from medseg_tpu_torch.core.config import CLIPSegFinetuneConfig
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.synthetic import synthetic_seg
    from medseg_tpu_torch.train import steps as S
    from medseg_tpu_torch.train.clipseg_finetune import clipseg_train_step, finetune_clipseg
    from medseg_tpu_torch.train.freeze import finetune_filter, set_trainable

    cond = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 24))).float()
    ds = synthetic_seg(n=13, img_size=20, seed=4)
    model = tiny_clipseg().train()
    opt = S.build_optimizer(1e-3, 5e-4, 1.0, set_trainable(model, finetune_filter("CLIPSeg")))
    images, masks = (shard_batch(a[:4], group) for a in (ds.images, ds.masks))
    with data_parallel(group):
        loss = clipseg_train_step(model, opt, images, masks, cond, model.logit_size(CLIPSEG_GRID),
                                  CLIPSEG_GRID)
    out = {"loss": loss.item(), **{f"grad/{k}": p.grad.clone()
                                   for k, p in model.named_parameters() if p.grad is not None}}
    logs = []
    best = finetune_clipseg(
        BatchLoader(ds, 4, shuffle=True, seed=3, indices=np.arange(8), device="cpu"),
        BatchLoader(ds, 4, shuffle=False, indices=np.arange(8, 13), device="cpu"),
        tiny_clipseg(), cond,
        CLIPSegFinetuneConfig(save_root=str(work / f"clipseg-w{group.size}"), epochs=1),
        image_size=CLIPSEG_GRID, log=logs.append, device="cpu", mesh=group)
    return {**out, "logs": logs, "best": best}


def case_collectives(group, work: Path) -> dict:
    """replicate_ of a module whose weights differ by rank (rank 0's
    everywhere after it), shard_process_local with equal and with unequal
    row counts (every rank raises on the unequal), and all_gather."""
    from medseg_tpu_torch.parallel import dist as pdist
    from medseg_tpu_torch.parallel import replicate_

    torch.manual_seed(group.rank)
    model = replicate_(conv_bn(torch.float32), group)
    rows = pdist.shard_process_local(np.full((3, 2), group.rank), group)
    try:
        pdist.shard_process_local(np.zeros((2 + group.rank, 2)), group)
        raised = ""
    except ValueError as e:
        raised = str(e)
    gathered = group.all_gather(torch.tensor([group.rank, 10 + group.rank]))
    return {"state": {k: v.clone() for k, v in model.state_dict().items()},
            "rows": rows, "raised": raised, "gathered": torch.stack(gathered)}


CASES = {"collectives": case_collectives, "bn": case_bn, "cls": case_cls, "explicit": case_explicit, "eval": case_eval,
         "seg": case_seg, "trainer": case_trainer, "clipseg": case_clipseg}


def main(argv) -> None:
    store, world, rank, work, cases = argv
    torch.set_num_threads(1)
    os.environ.update(MEDSEG_COORDINATOR=f"file://{store}", MEDSEG_NUM_PROCESSES=world,
                      MEDSEG_PROCESS_ID=rank)
    import torch.distributed as dist

    from medseg_tpu_torch.parallel import data_parallel_mesh, initialize_from_env

    assert initialize_from_env(device="cpu")
    group = data_parallel_mesh("cpu")
    assert (group.rank, group.size) == (int(rank), int(world))
    try:
        for case in cases.split(","):
            torch.save(CASES[case](group, Path(work)), Path(work) / f"{case}.rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
