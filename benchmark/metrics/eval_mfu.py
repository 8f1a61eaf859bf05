"""eval_mfu: forward FLOPs of the images evaluated in the traced window,
over the window's seconds and the cell's chips, as a share of the peak of
the precision the convs ran in: TF32's where the trace names a TF32
kernel, else float32's outside the tensor cores."""

import sys

from benchmark.harness import bounds, manifest


def read(ctx):
    s, c = ctx.session, ctx.counters
    if not c.get("images") or not s.ops:
        return None
    tf32 = s.count(lambda n: "tf32" in n.lower()) > 0
    print(f"eval_mfu: the convs ran in {'tf32' if tf32 else 'float32'}", file=sys.stderr)
    peak = bounds.TF32_FLOPS_PER_S if tf32 else bounds.F32_FLOPS_PER_S
    rate = manifest.flop_count(ctx.cell.config).forward_flops(ctx.cell.config["architecture"]) * c["images"] / s.window_s
    return 100.0 * rate / c["chips"] / peak
