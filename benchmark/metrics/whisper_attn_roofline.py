"""K2's bias-free instantiation (plain float32 attention, Whisper's) against
its roofline: the least time of the window's attention work, the larger of
its operations at the TF32 tensor-core peak and its bytes at the HBM rate
(the model's ``attn_work`` for each unit's utterances, over every layer and
all 1500 positions; the convention of ``k2_roofline``), over the summed
device time of the kernels whose names hold ``nobias_flash_kernel``, in
percent. Nothing to read where the configuration's encoder runs no such
attention or the trace holds no such kernel."""
from benchmark import yardstick

KERNEL = "nobias_flash_kernel"


def read(ctx):
    measured = ctx.kernel_seconds(name_has=KERNEL)
    shape = getattr(ctx.model, "attn_shape", None)
    if ctx.peaks is None or shape is None or measured <= 0:
        return None
    layers, B, H, T, hd = shape(ctx.config,
                                yardstick.unit_windows(ctx.entry, ctx.traffic),
                                ctx.traffic["samples"])
    ops, nbytes = ctx.model.attn_work(B, H, T, hd)
    least = ctx.units * layers * yardstick.least_seconds(
        ops, nbytes, ctx.peaks["tf32_flops"], ctx.peaks["hbm_bytes"])
    return 100.0 * least / measured
