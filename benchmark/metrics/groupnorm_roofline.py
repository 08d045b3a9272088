"""K5 (vq-wav2vec's one-group GroupNorm, affine and activation, float32)
against its roofline: the least time of the window's K5 work, each
element of each layer's conv output read once and the activated result
written once (8 B an element) at the HBM rate, over the summed device time
of the kernels whose names hold ``groupnorm1_``, in percent. Nothing to
read where the configuration is not vq-wav2vec or the trace holds no K5
kernel."""
from benchmark import yardstick

KERNEL = "groupnorm1_"
BYTES_PER_ELEMENT = 8.0       # float32 read once, written once


def window_bytes(cfg: dict, n_samples: int) -> float:
    """Least bytes of K5 over one window: 8 B x sum over the layers of
    C_l T_l, T_l the frames out of layer l's convolution."""
    elems, T = 0, n_samples
    for dim, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"],
                         cfg["conv_stride"]):
        T = yardstick.conv_out(T, k, s)
        elems += dim * T
    return BYTES_PER_ELEMENT * elems


def read(ctx):
    if ctx.config.get("model") != "vq_wav2vec":
        return None
    measured = ctx.kernel_seconds(name_has=KERNEL)
    if ctx.peaks is None or measured <= 0:
        return None
    B = yardstick.unit_windows(ctx.entry, ctx.traffic)
    least = ctx.units * B * window_bytes(
        ctx.config, ctx.traffic["samples"]) / ctx.peaks["hbm_bytes"]
    return 100.0 * least / measured
