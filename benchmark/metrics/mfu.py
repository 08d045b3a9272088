"""Counted floating-point work of the window's units (encoder, cosine
tables, decode; yardstick.unit_flops) over the traced window's seconds
times the TF32 tensor-core peak, in percent."""
from benchmark import yardstick
from benchmark.reference import matching


def read(ctx):
    if ctx.peaks is None or ctx.window_s <= 0:
        return None
    g = matching.geometry(ctx.config["match"]["audio_mode"])
    slots, _ = matching.text_slots()
    flops = ctx.units * yardstick.unit_flops(
        ctx.config, ctx.model, ctx.entry, ctx.traffic, len(g.step_frame),
        len(g.block_code), len(slots))
    return 100.0 * flops / (ctx.window_s * ctx.peaks["tf32_flops"])
