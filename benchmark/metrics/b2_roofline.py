"""b2_roofline: the least time of the photometric kernel's eval-form
launches in the traced window (harness/bounds.py photometric_bound_ms, no
per-sample scalars, at the rows it normalized) over its own device time."""

from benchmark.harness import bounds


def read(ctx):
    t = ctx.session.device_time(lambda n: "photometric_kernel<" in n)
    rows = ctx.counters.get("b2_rows", 0)
    if t <= 0 or not rows:
        return None
    h, w, c, out_bytes = ctx.counters["b2_shape"]
    bound_ms, _ = bounds.photometric_bound_ms(rows, h, w, c, out_bytes, per_sample=False)
    return 100.0 * bound_ms / (t * 1e3)
