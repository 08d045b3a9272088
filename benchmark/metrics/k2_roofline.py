"""K2 (gated flash attention, float32) against its roofline: the least
time of the window's attention calls, the larger of their operations at
the TF32 tensor-core peak and their bytes at the HBM rate, over K2's summed
device time, in percent."""
from benchmark import yardstick

KERNEL = "gated_flash_kernel"


def read(ctx):
    measured = ctx.kernel_seconds(name_has=KERNEL)
    shape = ctx.model.attention(ctx.config, ctx.traffic["samples"])
    if ctx.peaks is None or shape is None or measured <= 0:
        return None
    layers, H, T, hd = shape
    B = yardstick.unit_windows(ctx.entry, ctx.traffic)
    ops, nbytes = yardstick.k2_work(B, H, T, hd)
    least = ctx.units * layers * yardstick.least_seconds(
        ops, nbytes, ctx.peaks["tf32_flops"], ctx.peaks["hbm_bytes"])
    return 100.0 * least / measured
