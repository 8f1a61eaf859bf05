"""b1_roofline: the least time of the warp kernel's launches in the traced
window (harness/bounds.py warp_bound_ms at the rows it warped, linear in
the rows) over its own device time in the trace."""

from benchmark.harness import bounds


def read(ctx):
    t = ctx.session.device_time(lambda n: "warp_affine_kernel<" in n)
    rows = ctx.counters.get("b1_rows", 0)
    if t <= 0 or not rows:
        return None
    h, w, c, out_bytes = ctx.counters["b1_shape"]
    bound_ms, _ = bounds.warp_bound_ms(rows, h, w, c, out_bytes)
    return 100.0 * bound_ms / (t * 1e3)
