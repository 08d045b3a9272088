"""Device milliseconds of the kernels that ran between the marks at the
VQ-VAE decoder's forward start and end (the benchmark's hooks on the
decoder module), per unit."""


def read(ctx):
    s = ctx.kernel_seconds(stage="decode")
    return s / ctx.units * 1e3 if s > 0 else None
