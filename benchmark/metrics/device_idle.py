"""Share of the traced window in which no operation ran on the card."""


def read(ctx):
    s = ctx.session
    if not s.ops or s.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - s.busy_s / s.window_s)
