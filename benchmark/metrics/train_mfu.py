"""train_mfu: model FLOPs of the images trained in the traced window
(the configuration's `flops` module, from shapes), over the window's seconds and the cell's
chips, as a share of the card's dense bf16 peak."""

from benchmark.harness import bounds, manifest


def read(ctx):
    s, c = ctx.session, ctx.counters
    if not c.get("images") or s.window_s <= 0:
        return None
    rate = manifest.flop_count(ctx.cell.config).train_flops(ctx.cell.config["architecture"]) * c["images"] / s.window_s
    return 100.0 * rate / c["chips"] / bounds.BF16_FLOPS_PER_S
