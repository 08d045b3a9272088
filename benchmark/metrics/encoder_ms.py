"""Device milliseconds of the kernels that ran between the marks at the
audio encoder's forward start and end (the benchmark's hooks on the
encoder module), per unit."""


def read(ctx):
    s = ctx.kernel_seconds(stage="encoder")
    return s / ctx.units * 1e3 if s > 0 else None
