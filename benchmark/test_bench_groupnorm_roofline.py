"""K5's roofline reader (metrics/groupnorm_roofline.py) on hand-counted
shapes and a hand-built trace: the vq-wav2vec cells' bytes, the share it
reports, and nothing to read for WavLM or a trace without K5."""
import json
import os

import pytest

from benchmark import devtrace, spec, yardstick
from benchmark.entries import serve, serve_batch

HERE = os.path.dirname(os.path.abspath(__file__))
VQ = "vq-wav2vec-j16384"


def _cfg(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def _metric():
    return spec.plugin("metrics", "groupnorm_roofline")


def test_bytes_of_a_window_by_hand():
    """512 channels over the 8 layers' 12 799, 3 198, 1 598, 798 and 4 x
    398 frames: 10.23 M floats a window, 8 B each; 491 MB a clip of 6
    windows, 0.147 ms at 3.35 TB/s."""
    elems = 512 * (12799 + 3198 + 1598 + 798 + 4 * 398)
    assert elems == 10_232_320
    per_window = _metric().window_bytes(_cfg(VQ), 64000)
    assert per_window == 8.0 * elems
    assert 6 * per_window == pytest.approx(491e6, rel=1e-3)
    assert 6 * per_window / 3.35e12 == pytest.approx(0.147e-3, rel=1e-2)


@pytest.mark.parametrize("cell,entry,windows", [
    (VQ + ".clip", serve, 6), (VQ + ".batch16", serve_batch, 96)])
def test_share_on_a_hand_built_trace(cell, entry, windows):
    traffic = spec.load_cell(cell).traffic
    assert yardstick.unit_windows(entry, traffic) == windows
    kernels = [
        devtrace.Kernel("(anonymous namespace)::groupnorm1_moments_kernel("
                        "float const*, float*, long long, long long, int)",
                        0.0, 1e-3, "encoder"),
        devtrace.Kernel("void (anonymous namespace)::groupnorm1_apply_kernel"
                        "<0>(float const*, float*)", 1e-3, 3e-3, "encoder"),
        devtrace.Kernel("RowwiseMomentsCUDAKernel", 3e-3, 4e-3, "encoder")]
    ctx = devtrace.TraceContext(
        cell=cell, config=_cfg(VQ), traffic=traffic, device_name="NVIDIA H100",
        peaks=yardstick.H100_SXM, units=2, window=(0.0, 4e-3),
        kernels=kernels, model=spec.plugin("models", "vq_wav2vec"),
        entry=entry)
    read = spec.reader(f"groupnorm_roofline.{cell.split('.')[1]}")
    least = 2 * windows * 8.0 * 10_232_320 / 3.35e12
    assert read(ctx) == pytest.approx(100.0 * least / 3e-3)
    without = devtrace.TraceContext(**{**ctx.__dict__,
                                       "kernels": kernels[2:]})
    assert read(without) is None               # the parent: no K5 kernel
    wavlm = devtrace.TraceContext(**{
        **ctx.__dict__, "config": _cfg("wavlm-large-j1024"),
        "model": spec.plugin("models", "wavlm")})
    assert read(wavlm) is None                 # not vq-wav2vec
