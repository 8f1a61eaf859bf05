"""h2d_ms_per_batch.eval: device time of the host-to-device copies in the
traced window per eval batch (the loader without a device cache copies
each batch from pageable memory)."""


def read(ctx):
    t = ctx.session.device_time(lambda n: "HtoD" in n)
    batches = ctx.counters.get("batches", 0)
    return 1e3 * t / batches if t > 0 and batches else None
