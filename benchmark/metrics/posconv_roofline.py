"""K6 (WavLM's positional convolution with its bias, GELU and residual,
float32) against its roofline: the least time of the window's positional
conv work, the larger of its 2 B T D (D / G) k FLOPs at the TF32
tensor-core peak (as k2_roofline and relkey_roofline hold their kernels,
so that no sound design reads over 100 %; a perfect float32 FMA kernel
reads 67 / 495 = 13.5 %) and its bytes at the HBM rate (feats read for the
products and for the residual, the output written, the weights read once),
over the summed device time of the kernels whose names hold ``posconv_``,
in percent. Nothing to read where the configuration is not WavLM or the
trace holds no K6 kernel."""
from benchmark import yardstick

KERNEL = "posconv_"


def work(cfg: dict, B: int, n_samples: int):
    """(FLOPs, bytes) of the positional conv over B windows of n_samples:
    2 B T D (D / G) k; 4 (2 B T D + B T D + D (D / G) k)."""
    T = yardstick.conv_frames(cfg, n_samples)
    D = cfg["hidden_size"]
    G, k = cfg["num_conv_pos_embedding_groups"], cfg["num_conv_pos_embeddings"]
    return (2.0 * B * T * D * (D // G) * k,
            4.0 * (2 * B * T * D + B * T * D + D * (D // G) * k))


def read(ctx):
    if ctx.config.get("model") != "wavlm":
        return None
    measured = ctx.kernel_seconds(name_has=KERNEL)
    if ctx.peaks is None or measured <= 0:
        return None
    B = yardstick.unit_windows(ctx.entry, ctx.traffic)
    ops, nbytes = work(ctx.config, B, ctx.traffic["samples"])
    least = ctx.units * yardstick.least_seconds(
        ops, nbytes, ctx.peaks["tf32_flops"], ctx.peaks["hbm_bytes"])
    return 100.0 * least / measured
