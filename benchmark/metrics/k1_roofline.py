"""K1 (edit-distance matrix) against its roofline: the least time of each
unit's Q x N x L^2 DP cells at two cells per 32-bit lane operation, or of
its bytes at the HBM rate, over K1's summed device time, in percent."""
from benchmark import yardstick
from benchmark.reference import matching

KERNEL = "lev_kernel"
STRING = 11


def read(ctx):
    cfg = ctx.config
    measured = ctx.kernel_seconds(name_has=KERNEL)
    if ctx.peaks is None or cfg["match"]["audio_mode"] != "wavvq_feat" \
            or measured <= 0:
        return None
    g = matching.geometry("wavvq_feat")
    Q = yardstick.unit_windows(ctx.entry, ctx.traffic) * len(g.step_frame)
    N = cfg["database"]["windows"] * len(g.block_code)
    cells, nbytes = yardstick.k1_work(Q, N, STRING)
    least = ctx.units * yardstick.least_seconds(
        cells, nbytes, yardstick.k1_cells_per_s(ctx.peaks),
        ctx.peaks["hbm_bytes"])
    return 100.0 * least / measured
