"""capture_ms_per_epoch: ScanDrive.capture_s (the program's host-clock span
of a capture and instantiation, which synchronizes), summed over the traced
window's captures, per epoch."""


def read(ctx):
    c = ctx.counters
    if not c.get("epochs"):
        return None
    return 1e3 * c["capture_s"] / c["epochs"]
