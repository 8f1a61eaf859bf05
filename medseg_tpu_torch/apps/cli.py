"""Command-line interface of the port.

    python -m medseg_tpu_torch.apps.cli split    # seed-42 stratified 80/10/10 CSVs
    python -m medseg_tpu_torch.apps.cli pack     # decode+resize into packed caches
    python -m medseg_tpu_torch.apps.cli train [MODELS...] [--epochs 20] [--profile DIR]
                                              [--scan-chunk K]
    python -m medseg_tpu_torch.apps.cli eval  [--batch-size 16] [--compare DIR]
    python -m medseg_tpu_torch.apps.cli parity [--reference DIR] [--tolerance 0.5]
    python -m medseg_tpu_torch.apps.cli finetune-clip    --random-init
    python -m medseg_tpu_torch.apps.cli finetune-clipseg --random-init
    python -m medseg_tpu_torch.apps.cli demo    [--builtin] [--port 7860] [--no-warmup]
    python -m medseg_tpu_torch.apps.cli serve   [--port 8000] [--no-warmup]
    python -m medseg_tpu_torch.apps.cli predict --input DIR [--output DIR]

Counterpart of medseg_tpu/apps/cli.py's `split` and `pack` (:40-55),
`train` (:98-140), `eval` (:143-176), `parity` (:179-231), `finetune-clip`
and `finetune-clipseg` (:235-319), `demo`, `serve` and `predict`, with the
same arguments, defaults and printed lines; `parity --reference` defaults
to reference/results, relative to the working directory.  `split` and
`pack` are host work and never touch the card; every other command runs on
the card unless `--device cpu` is passed.  Shared paths: --root (the
dataset; --cache-dir defaults to {root}/packed, the JAX CLI's default
"dataset/packed"), --cache-dir (the packed caches that `pack` writes),
--weights-root and --results-dir.  `train --profile DIR` writes a
torch.profiler trace of each model's run into DIR (utils/profiling.py).
`--prompt-ids PATH` names the JSON bundle of CLIP's and CLIPSeg's prompt
token ids (it sets $MEDSEG_PROMPT_IDS, interop/prompts.py); checkpoints
that the finetuners wrote carry their own prompt features and need none.

Loaders keep each packed split on the card (BatchLoader's device cache,
within its budget), as the JAX CLI's single-chip `train` does.  The
finetuners without `--random-init` raise the JAX package's offline error:
the HuggingFace route (medseg_tpu/interop/hf_pretrained.py) needs a
download and is not ported.  `--random-init` builds the full-size model
with init_weights from a seeded torch.Generator, and the JAX package's
prompt features / conditional embedding drawn from default_rng(0).

Data parallelism: `main` joins the process group that MEDSEG_COORDINATOR,
MEDSEG_NUM_PROCESSES and MEDSEG_PROCESS_ID describe (parallel/dist.py)
before anything touches the card, and `--data-parallel` (train, eval,
finetune-clip, finetune-clipseg) splits every global batch over it, one
process per GPU, each on cuda:{MEDSEG_PROCESS_ID % device count}; rank 0
writes the checkpoints and CSVs.  Without MEDSEG_* it runs a world-1 group
on this process's device: the JAX CLI's mesh spans every local device
from one process, which PyTorch does only through the deprecated
nn.DataParallel, so several GPUs take one process each, e.g.

    export MEDSEG_COORDINATOR=127.0.0.1:29500 MEDSEG_NUM_PROCESSES=2
    MEDSEG_PROCESS_ID=0 python -m medseg_tpu_torch.apps.cli train --data-parallel &
    MEDSEG_PROCESS_ID=1 python -m medseg_tpu_torch.apps.cli train --data-parallel

`--scan-chunk K` (train, finetune-clip, finetune-clipseg) runs whole
chunks of K train steps of an epoch as one CUDA-graph replay on the card,
and the same steps eagerly on the CPU, with the same results as without it
(train/steps.scan_epoch_driver).  With `--data-parallel` it needs an NCCL
group: under gloo on the card the command raises.

Not registered, so argparse refuses them (ROADMAP):
- --auto-restart (A.16: decided not to port; it restarted after relay drops);
- `install-data` (a download), `bench` (A.7) and `export-torch` (the port
  reads and writes the reference's .pt key names directly).
"""

from __future__ import annotations

import argparse
import glob
import os
from pathlib import Path

import numpy as np

from medseg_tpu_torch.core.config import NUM_CLASSES, DataConfig, EvalConfig, TrainConfig

DEFAULT_TRAIN_MODELS = ["ResNet50", "ResNet18", "VGG16", "VGG19",
                        "ResNetUnet", "AttentionUNet", "R2Unet", "R2AttUnet"]
CLIP_NAME = "openai/clip-vit-base-patch32"
CLIPSEG_NAME = "CIDAS/clipseg-rd64-refined"
FINETUNE_VAL_FRACTION = 0.1111  # medseg_tpu/apps/cli.py:295
SCAN_HELP = ("run K {} steps per dispatched program (a CUDA graph of K steps "
             "over the card's dataset cache, replayed once per chunk; exact same "
             "math/RNG stream: removes the host's per-step dispatch; composes with "
             "--data-parallel)")
DP_HELP = ("{}: here one process per GPU, joined by MEDSEG_COORDINATOR / "
           "MEDSEG_NUM_PROCESSES / MEDSEG_PROCESS_ID; without them a world-1 "
           "group on this process's device")


def _cmd_split(args):
    from medseg_tpu_torch.data.splits import generate_splits

    generate_splits(DataConfig(root=args.root, splits_dir=f"{args.root}/splits"))


def _cmd_pack(args):
    from medseg_tpu_torch.data.packed import pack_split, save_packed

    cfg = DataConfig(root=args.root, splits_dir=f"{args.root}/splits")
    for split in ("train", "val", "test"):
        for task in ("cls", "seg"):
            ds = pack_split(cfg, split, task)
            save_packed(ds, args.cache_dir, f"{split}_{task}")
            print(f"packed {split}/{task}: {len(ds)} samples")


def _loaders(cache_dir: str, task: str, batch_size: int, val_fraction: float, device):
    """(train, validation) loaders over `train_{task}`, split by
    split_train_val with seed 0 (medseg_tpu/apps/cli.py:58-75).  The device
    is resolved first: without a card it raises before reading the caches."""
    from medseg_tpu_torch.core.device import resolve_device
    from medseg_tpu_torch.data.loader import BatchLoader, split_train_val
    from medseg_tpu_torch.data.packed import load_packed

    device = resolve_device(device)
    ds = load_packed(cache_dir, f"train_{task}")
    tr_idx, va_idx = split_train_val(len(ds), val_fraction)
    train = BatchLoader(ds, batch_size, shuffle=True, indices=tr_idx,
                        device_cache=True, device=device)
    val = BatchLoader(ds, batch_size, shuffle=False, indices=va_idx, device_cache=True,
                      device=device)
    return train, val


def _mesh_if(args):
    """`--data-parallel` -> the data-parallel group (every process that
    joined, or this one alone), else None (medseg_tpu/apps/cli.py:78-95)."""
    if not getattr(args, "data_parallel", False):
        return None
    import torch.distributed as dist

    from medseg_tpu_torch.parallel import data_parallel_mesh

    if dist.is_initialized():
        print(f"[INFO] multi-host: process {dist.get_rank()}/{dist.get_world_size()}")
    mesh = data_parallel_mesh(args.device)
    print(f"[INFO] data-parallel over {mesh.size} devices")
    return mesh


def _cmd_train(args):
    from medseg_tpu_torch.core.registry import get_model
    from medseg_tpu_torch.train import train_model
    from medseg_tpu_torch.utils.profiling import trace_context

    cfg = TrainConfig(epochs=args.epochs, lr=args.lr, save_root=args.weights_root,
                      compute_dtype=args.dtype)
    mesh = _mesh_if(args)
    results, tasks = {}, {}
    for name in args.models:
        task = get_model(name)["task"]
        tasks[name] = task
        seg = task == "segmentation"
        bs = args.batch_size or (cfg.seg_batch_size if seg else cfg.cls_batch_size)
        print(f"\n--- Training {task} model: {name} ---")
        train, val = _loaders(args.cache_dir, "seg" if seg else "cls", bs,
                              cfg.val_fraction, device=args.device)
        with trace_context(args.profile, args.device):
            res = train_model(name, train, val, cfg, resume=args.resume,
                              device=args.device, mesh=mesh, scan_chunk=args.scan_chunk)
        results[name] = res.best_score

    print("\n\n=============== Training Summary ===============")
    # by task, not by name (the reference's "Unet" filter drops AttentionUNet)
    for k, v in sorted(results.items()):
        if tasks[k] == "classification":
            print(f"{k:<15}: {v:.2f}% Acc (Classification)")
        else:
            print(f"{k:<15}: {v:.4f} Loss (Segmentation)")
    print("================================================")


def _cmd_eval(args):
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.packed import load_packed
    from medseg_tpu_torch.eval.csv_io import save_results_to_csv
    from medseg_tpu_torch.eval.harness import print_summary, test_all_models

    cfg = EvalConfig(batch_size=args.batch_size, weights_root=args.weights_root,
                     results_dir=args.results_dir)
    cls_loader = seg_loader = None
    try:
        cls_loader = BatchLoader(load_packed(args.cache_dir, "test_cls"), cfg.batch_size,
                                 shuffle=False, device=args.device)
    except FileNotFoundError:
        print("[WARNING] Classification test cache not found; skipping.")
    try:
        seg_loader = BatchLoader(load_packed(args.cache_dir, "test_seg"),
                                 cfg.batch_size // 2, shuffle=False, device=args.device)
    except FileNotFoundError:
        print("[WARNING] Segmentation test cache not found; skipping.")
    mesh = _mesh_if(args)
    results = test_all_models(cls_loader, seg_loader, cfg, device=args.device, mesh=mesh)
    print_summary(results)
    cls_csv = f"{cfg.results_dir}/classification_test_results.csv"
    seg_csv = f"{cfg.results_dir}/segmentation_test_results.csv"
    if mesh is None or mesh.rank == 0:  # rank 0 writes the CSVs
        save_results_to_csv(results, cls_csv, seg_csv)
    if mesh is not None:
        mesh.barrier()  # the CSVs are whole before any rank compares them
    if args.compare:
        from medseg_tpu_torch.eval.parity import compare_results_csv, format_parity_report

        for ours, ref in _csv_pairs(cls_csv, seg_csv, args.compare):
            print(f"\n=== Parity vs {ref} ===")
            format_parity_report(compare_results_csv(ours, str(ref)))


def _csv_pairs(cls_csv: str, seg_csv: str, ref_dir: str):
    """(produced CSV, reference CSV) for each of the two that both exist."""
    for ours, ref_name in ((cls_csv, "classification_test_results.csv"),
                           (seg_csv, "segmentation_test_results.csv")):
        ref = Path(ref_dir) / ref_name
        if Path(ours).exists() and ref.exists():
            yield ours, ref


def _cmd_parity(args):
    """One-command real-data parity replay: split -> pack the test split ->
    evaluate every model whose weights exist -> compare the produced CSVs
    against the reference's published results/*.csv.  Exits 1 when any
    metric deviates beyond tolerance or a reference model is missing, 2
    when there is nothing to compare."""
    from medseg_tpu_torch.data.loader import BatchLoader
    from medseg_tpu_torch.data.packed import load_packed, pack_split, save_packed
    from medseg_tpu_torch.data.splits import generate_splits
    from medseg_tpu_torch.eval.csv_io import save_results_to_csv
    from medseg_tpu_torch.eval.harness import print_summary, test_all_models
    from medseg_tpu_torch.eval.parity import compare_results_csv, format_parity_report

    data_cfg = DataConfig(root=args.root, splits_dir=f"{args.root}/splits")
    if not data_cfg.split_csv("test").exists():
        generate_splits(data_cfg)
    for task in ("cls", "seg"):
        if not (Path(args.cache_dir) / f"test_{task}_images.npy").exists():
            ds = pack_split(data_cfg, "test", task)
            save_packed(ds, args.cache_dir, f"test_{task}")
            print(f"packed test/{task}: {len(ds)} samples")

    cfg = EvalConfig(batch_size=args.batch_size, weights_root=args.weights_root,
                     results_dir=args.results_dir)
    cls_loader = BatchLoader(load_packed(args.cache_dir, "test_cls"), cfg.batch_size,
                             shuffle=False, device=args.device)
    seg_loader = BatchLoader(load_packed(args.cache_dir, "test_seg"),
                             max(1, cfg.batch_size // 2), shuffle=False, device=args.device)
    results = test_all_models(cls_loader, seg_loader, cfg, device=args.device)
    print_summary(results)
    cls_csv = f"{cfg.results_dir}/classification_test_results.csv"
    seg_csv = f"{cfg.results_dir}/segmentation_test_results.csv"
    save_results_to_csv(results, cls_csv, seg_csv)

    ok = True
    any_compared = False
    for ours, ref in _csv_pairs(cls_csv, seg_csv, args.reference):
        any_compared = True
        print(f"\n=== Parity vs {ref} (tolerance {args.tolerance} pp) ===")
        report = compare_results_csv(ours, str(ref), tolerance=args.tolerance)
        format_parity_report(report)
        ok = ok and report["within_tolerance"]
    if not any_compared:
        print("[ERROR] nothing to compare: no produced/reference CSV pairs")
        raise SystemExit(2)
    print(f"\nPARITY {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)


def _offline_error(name: str) -> RuntimeError:
    """medseg_tpu/interop/hf_pretrained.py:27-31's error."""
    exc = ModuleNotFoundError("the port has no HuggingFace route; pass --random-init")
    return RuntimeError(
        f"could not load {name} from HuggingFace (offline environment?). "
        f"Pre-populate the HF cache or pass converted variables directly. "
        f"Original error: {exc}")


def random_prompt_features(dim: int) -> np.ndarray:
    """The JAX CLI's random prompt features: [3, dim] default_rng(0) normal
    draws, each row L2-normalized (medseg_tpu/apps/cli.py:235-256)."""
    tf = np.random.default_rng(0).standard_normal((NUM_CLASSES, dim)).astype(np.float32)
    return tf / np.linalg.norm(tf, axis=-1, keepdims=True)


def random_cond(dim: int) -> np.ndarray:
    """The JAX CLI's random conditional embedding (cli.py:259-277)."""
    return np.random.default_rng(0).standard_normal((1, dim)).astype(np.float32)


def _random_init(name: str, device):
    """The full-size registry model on `device`, init_weights drawn from a
    torch.Generator seeded 0 on that device: the offline stand-in for the
    HF pretrained tower (metrics from it are meaningless; the recipe,
    shapes and checkpoint are the pretrained path's)."""
    import torch

    from medseg_tpu_torch.core.device import resolve_device
    from medseg_tpu_torch.core.registry import get_model

    print(f"[WARNING] --random-init: finetuning a RANDOMLY initialized {name} "
          f"(no HF weights; metrics will be meaningless — smoke/cert only)")
    device = resolve_device(device)
    entry = get_model(name)
    return entry["init_weights"](entry["factory"](device=device),
                                 torch.Generator(device=device).manual_seed(0))


def random_init_clip(device=None):
    """(CLIPClassifier, prompt features) of `finetune-clip --random-init`."""
    model = _random_init("CLIP", device)
    return model, random_prompt_features(model.visual_projection.out_features)


def random_init_clipseg(device=None):
    """(CLIPSegModel, conditional embedding) of `finetune-clipseg --random-init`."""
    model = _random_init("CLIPSeg", device)
    return model, random_cond(model.decoder.film_mul.in_features)


def _cmd_finetune(args):
    """finetune-clip / finetune-clipseg (medseg_tpu/apps/cli.py:280-319)."""
    from medseg_tpu_torch.core.config import CLIPFinetuneConfig, CLIPSegFinetuneConfig
    from medseg_tpu_torch.train.clip_finetune import finetune_clip
    from medseg_tpu_torch.train.clipseg_finetune import finetune_clipseg

    config, hf_name, task, random_init, finetune = (
        (CLIPSegFinetuneConfig, CLIPSEG_NAME, "seg", random_init_clipseg, finetune_clipseg)
        if args.cmd == "finetune-clipseg" else
        (CLIPFinetuneConfig, CLIP_NAME, "cls", random_init_clip, finetune_clip))
    cfg = config(save_root=args.weights_root, epochs=args.epochs,
                 **({"batch_size": args.batch_size} if args.batch_size else {}))
    if not args.random_init:
        raise _offline_error(hf_name)
    model, aux = random_init(args.device)
    train, val = _loaders(args.cache_dir, task, cfg.batch_size, FINETUNE_VAL_FRACTION,
                          device=args.device)
    finetune(train, val, model, aux, cfg, device=args.device, mesh=_mesh_if(args),
             scan_chunk=args.scan_chunk)


def _cmd_demo(args):
    from medseg_tpu_torch.apps.demo import launch_builtin_demo, launch_demo

    cfg = EvalConfig(weights_root=args.weights_root)
    if args.builtin:
        launch_builtin_demo(cfg, host=args.host, port=args.port,
                            warmup=not args.no_warmup, device=args.device)
    else:
        launch_demo(share=args.share, cfg=cfg, host=args.host, port=args.port,
                    warmup=not args.no_warmup, device=args.device)


def _cmd_predict(args):
    from medseg_tpu_torch.infer.batch import batch_predict

    paths = sorted(glob.glob(f"{args.input}/*.png") + glob.glob(f"{args.input}/*.jpg"))
    if not paths:
        print(f"no images found under {args.input}")
        return
    batch_predict(paths, cls_name=args.cls_model, seg_name=args.seg_model,
                  cfg=EvalConfig(weights_root=args.weights_root),
                  batch_size=args.batch_size, output_dir=args.output,
                  device=args.device)


def _cmd_serve(args):
    from medseg_tpu_torch.infer.server import InferenceServer

    server = InferenceServer(EvalConfig(weights_root=args.weights_root),
                             device=args.device)
    if not args.no_warmup:
        server.warmup()
    server.serve(host=args.host, port=args.port)


def main(argv=None):
    p = argparse.ArgumentParser(prog="medseg_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn):
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("--root", default="dataset")
        sp.add_argument("--cache-dir", default=None,
                        help="packed caches (default: {root}/packed)")
        sp.add_argument("--weights-root", default="weights")
        sp.add_argument("--results-dir", default="results")
        sp.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to run "
                             "on the CPU)")
        sp.add_argument("--prompt-ids", default=None,
                        help="JSON bundle of CLIP's and CLIPSeg's prompt token "
                             "ids (sets $MEDSEG_PROMPT_IDS)")
        return sp

    add("split", _cmd_split)
    add("pack", _cmd_pack)
    sp = add("train", _cmd_train)
    sp.add_argument("models", nargs="*", default=DEFAULT_TRAIN_MODELS)
    sp.add_argument("--epochs", type=int, default=20)
    sp.add_argument("--lr", type=float, default=1e-6)
    sp.add_argument("--batch-size", type=int, default=None)
    sp.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--data-parallel", action="store_true",
                    help=DP_HELP.format("shard batches over all devices (Mesh('data'))"))
    sp.add_argument("--scan-chunk", type=int, default=0, help=SCAN_HELP.format("train"))
    sp.add_argument("--profile", default=None,
                    help="torch.profiler trace directory (TensorBoard-loadable)")
    sp = add("eval", _cmd_eval)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--compare", default=None,
                    help="directory of reference results CSVs for parity replay")
    sp.add_argument("--data-parallel", action="store_true",
                    help=DP_HELP.format("shard eval batches over all devices "
                                        "(Mesh('data'); ragged tails pad+trim, "
                                        "metrics unchanged)"))
    sp = add("parity", _cmd_parity)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--reference", default="reference/results",
                    help="directory with the reference's published results CSVs")
    sp.add_argument("--tolerance", type=float, default=0.5,
                    help="max |delta| in percentage points")
    for ft_name in ("finetune-clip", "finetune-clipseg"):
        sp = add(ft_name, _cmd_finetune)
        sp.add_argument("--data-parallel", action="store_true",
                        help=DP_HELP.format("shard batches over all devices (Mesh('data'))"))
        sp.add_argument("--scan-chunk", type=int, default=0,
                        help=SCAN_HELP.format("finetune") + "; the step draws nothing")
        sp.add_argument("--epochs", type=int, default=20)
        sp.add_argument("--batch-size", type=int, default=None)
        sp.add_argument("--random-init", action="store_true",
                        help="finetune a randomly initialized full-size tower "
                             "instead of the HF pretrained one (offline smoke "
                             "and certification; metrics are meaningless)")
    sp = add("demo", _cmd_demo)
    sp.add_argument("--share", action="store_true")
    sp.add_argument("--builtin", action="store_true",
                    help="force the gradio-free builtin web UI")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=7860)
    sp.add_argument("--no-warmup", action="store_true")
    sp = add("predict", _cmd_predict)
    sp.add_argument("--input", required=True)
    sp.add_argument("--output", default="predictions")
    sp.add_argument("--cls-model", default="ResNet18")
    sp.add_argument("--seg-model", default="ResNetUnet")
    sp.add_argument("--batch-size", type=int, default=64)
    sp = add("serve", _cmd_serve)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--no-warmup", action="store_true",
                    help="skip loading and warming the default model pair at "
                         "startup")

    args = p.parse_args(argv)
    # a multi-process job joins its group before anything touches the card;
    # a no-op without MEDSEG_COORDINATOR (parallel/dist.py)
    from medseg_tpu_torch.parallel.dist import initialize_from_env

    initialize_from_env(device=args.device)
    if args.cache_dir is None:
        args.cache_dir = f"{args.root}/packed"
    if args.prompt_ids:
        os.environ["MEDSEG_PROMPT_IDS"] = args.prompt_ids
    args.fn(args)


def _run_as_command() -> None:
    """main() as `python -m medseg_tpu_torch.apps.cli` runs it, one command a
    process: then the process leaves the group the MEDSEG_* variables
    joined before the interpreter's teardown, which can otherwise abort a
    rank that still holds its gloo group ("terminate called without an
    active exception", exit -6) after the command's work is done.  On an
    exception the group is left to the teardown, as before."""
    import torch.distributed as dist

    main()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    _run_as_command()
