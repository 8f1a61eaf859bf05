"""Command-line interface of the port: `serve` and `predict`.

    python -m medseg_tpu_torch.apps.cli serve   [--port 8000] [--no-warmup]
    python -m medseg_tpu_torch.apps.cli predict --input DIR [--output DIR]

Counterpart of `_cmd_serve` and `_cmd_predict` in medseg_tpu/apps/cli.py,
with the same arguments and --weights-root (the JAX CLI's other shared
paths serve its other subcommands).  Both run on the card unless
`--device cpu` is passed, and serve every model of the zoo.
`--prompt-ids PATH` names the JSON bundle of CLIP's and CLIPSeg's prompt
token ids (it sets $MEDSEG_PROMPT_IDS, interop/prompts.py).  The other
subcommands wait for ROADMAP A.15.
"""

from __future__ import annotations

import argparse
import glob
import os

from medseg_tpu_torch.core.config import EvalConfig


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
        sp.add_argument("--weights-root", default="weights")
        sp.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' to run "
                             "on the CPU)")
        sp.add_argument("--prompt-ids", default=None,
                        help="JSON bundle of CLIP's and CLIPSeg's prompt token "
                             "ids (sets $MEDSEG_PROMPT_IDS)")
        return sp

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
    if args.prompt_ids:
        os.environ["MEDSEG_PROMPT_IDS"] = args.prompt_ids
    args.fn(args)


if __name__ == "__main__":
    main()
