"""K4 (relative-key flash attention, float32) against its roofline: the
least time of the window's K4 calls, the larger of their operations at the
TF32 tensor-core peak and their bytes at the HBM rate (the model's
``relkey_work``, the convention of ``k2_roofline``), over K4's summed
device time, in percent. Nothing to read where the configuration's encoder
runs no K4 or the trace holds no K4 kernel."""
from benchmark import yardstick

KERNEL = "relkey_flash_kernel"


def read(ctx):
    measured = ctx.kernel_seconds(name_has=KERNEL)
    shape = getattr(ctx.model, "relkey", None)
    if ctx.peaks is None or shape is None or measured <= 0:
        return None
    layers, H, T, hd, n_rel = shape(ctx.config, ctx.traffic["samples"])
    B = yardstick.unit_windows(ctx.entry, ctx.traffic)
    ops, nbytes = ctx.model.relkey_work(B, H, T, hd, n_rel)
    least = ctx.units * layers * yardstick.least_seconds(
        ops, nbytes, ctx.peaks["tf32_flops"], ctx.peaks["hbm_bytes"])
    return 100.0 * least / measured
