"""K7 (the per-code candidate reduction) against its roofline: the least
time of the window's K7 work, each side's (Q, N) distance matrix read once
(4 B a distance) with its N int64 codes at the HBM rate, over the summed
device time of the kernels whose names hold ``segmin_``, in percent. Q is
the unit's windows x 8 steps; N the database's windows x 26 blocks (audio)
or x 26 text slots. Nothing to read where the configuration is not
vq-wav2vec or the trace holds no K7 kernel."""
from benchmark import yardstick
from benchmark.reference import matching

KERNEL = "segmin_"
DIST_BYTES = 4.0              # float32 or int32, read once
CODE_BYTES = 8.0              # int64, read once


def unit_bytes(cfg: dict, windows: int) -> float:
    """Least bytes of K7 over one unit of ``windows`` 4 s windows."""
    g = matching.geometry(cfg["match"]["audio_mode"])
    Q = windows * len(g.step_frame)
    J = cfg["database"]["windows"]
    sides = []
    if cfg["match"]["use_aud"]:
        sides.append(J * len(g.block_code))
    if cfg["match"]["use_txt"]:
        sides.append(J * len(matching.text_slots()[0]))
    return sum(DIST_BYTES * Q * N + CODE_BYTES * N for N in sides)


def read(ctx):
    if ctx.config.get("model") != "vq_wav2vec":
        return None
    measured = ctx.kernel_seconds(name_has=KERNEL)
    if ctx.peaks is None or measured <= 0:
        return None
    windows = yardstick.unit_windows(ctx.entry, ctx.traffic)
    least = ctx.units * unit_bytes(ctx.config, windows) \
        / ctx.peaks["hbm_bytes"]
    return 100.0 * least / measured
