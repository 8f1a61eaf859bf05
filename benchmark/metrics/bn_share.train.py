"""bn_share.train: device time of the BatchNorm kernels (ATen's and
cuDNN's, by name) over the traced window's device-busy time."""

import re

BN = re.compile(r"batch_?norm|\bbn_", re.IGNORECASE)


def read(ctx):
    s = ctx.session
    t = s.device_time(lambda n: bool(BN.search(n)))
    return 100.0 * t / s.busy_s if t > 0 else None
