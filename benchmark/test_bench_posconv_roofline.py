"""K6's roofline reader (metrics/posconv_roofline.py) on hand-counted
shapes and a hand-built trace: the WavLM cells' FLOPs and bytes, the share
it reports, and nothing to read for another model or a trace without
K6."""
import json
import os

import pytest

from benchmark import devtrace, spec, yardstick
from benchmark.entries import serve, tick

HERE = os.path.dirname(os.path.abspath(__file__))
WAVLM = "wavlm-large-j1024"


def _cfg(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def _metric():
    return spec.plugin("metrics", "posconv_roofline")


def test_work_of_a_tick_by_hand():
    """16 windows of 199 frames, 1024 channels in 16 groups of 64, 128
    taps: 53.4 GFLOP, 0.108 ms at 495 TFLOP/s (0.80 ms at the 67 TFLOP/s
    float32 FMA rate, 13.5 % of it); ~73 MB, 0.022 ms at 3.35 TB/s."""
    ops, nbytes = _metric().work(_cfg(WAVLM), 16, 64000)
    assert ops == 2.0 * 16 * 199 * 1024 * 64 * 128
    assert ops == pytest.approx(53.4e9, rel=1e-3)
    assert nbytes == 4.0 * (3 * 16 * 199 * 1024 + 1024 * 64 * 128)
    assert nbytes == pytest.approx(72.7e6, rel=1e-3)
    assert ops / 67e12 == pytest.approx(0.80e-3, rel=1e-2)
    least = yardstick.least_seconds(ops, nbytes, 495e12, 3.35e12)
    assert least == ops / 495e12                  # bound by operations
    assert 100.0 * least / (ops / 67e12) == pytest.approx(13.5, abs=0.05)
    clip_ops, _ = _metric().work(_cfg(WAVLM), 6, 64000)
    assert clip_ops == pytest.approx(20.0e9, rel=2e-3)


@pytest.mark.parametrize("cell,entry,windows", [
    (WAVLM + ".clip", serve, 6), (WAVLM + ".pool16", tick, 16)])
def test_share_on_a_hand_built_trace(cell, entry, windows):
    traffic = spec.load_cell(cell).traffic
    assert yardstick.unit_windows(entry, traffic) == windows
    kernels = [
        devtrace.Kernel("void (anonymous namespace)::posconv_gelu_residual_"
                        "kernel<64>(float const*, float const*, float "
                        "const*, float*, int, int, int, int)",
                        0.0, 2e-3, "encoder"),
        devtrace.Kernel("void (anonymous namespace)::posconv_gelu_residual_"
                        "kernel<64>(float const*, float const*, float "
                        "const*, float*, int, int, int, int)",
                        3e-3, 4e-3, "encoder"),
        devtrace.Kernel("void implicit_convolve_sgemm<float, float, 1024, "
                        "5, 5, 3, 3, 3, 1, false, false, true>",
                        5e-3, 9e-3, "encoder")]
    ctx = devtrace.TraceContext(
        cell=cell, config=_cfg(WAVLM), traffic=traffic,
        device_name="NVIDIA H100", peaks=yardstick.H100_SXM, units=2,
        window=(0.0, 9e-3), kernels=kernels,
        model=spec.plugin("models", "wavlm"), entry=entry)
    read = spec.reader(f"posconv_roofline.{cell.split('.')[1]}")
    least = 2 * 2.0 * windows * 199 * 1024 * 64 * 128 / 495e12
    assert read(ctx) == pytest.approx(100.0 * least / 3e-3)
    without = devtrace.TraceContext(**{**ctx.__dict__,
                                       "kernels": kernels[2:]})
    assert read(without) is None               # the parent: no K6 kernel
    vq = devtrace.TraceContext(**{
        **ctx.__dict__, "config": _cfg("vq-wav2vec-j16384"),
        "model": spec.plugin("models", "vq_wav2vec")})
    assert read(vq) is None                    # not WavLM
