"""Percent of the traced window in which no device operation ran:
100 (1 - union of kernel intervals / window)."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s() / ctx.window_s)
