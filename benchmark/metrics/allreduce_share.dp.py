"""allreduce_share.dp: NCCL kernels' device time over the device-busy time
of rank 0's traced window."""


def read(ctx):
    s = ctx.session
    t = s.device_time(lambda n: "nccl" in n.lower())
    return 100.0 * t / s.busy_s if t > 0 else None
