"""K7's roofline reader (metrics/segmin_roofline.py) on hand-counted
shapes and a hand-built trace: batch16's bytes, a trace whose K7 time is
the bound reads 100 %, and nothing to read for WavLM or a trace without
K7."""
import json
import os

import pytest

from benchmark import devtrace, spec, yardstick
from benchmark.entries import serve_batch

HERE = os.path.dirname(os.path.abspath(__file__))
VQ = "vq-wav2vec-j16384"
CELL = VQ + ".batch16"


def _cfg(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_bytes_of_a_batch_by_hand():
    """16 clips of 6 windows, 8 steps each: 768 queries; 16384 database
    windows of 26 blocks (audio) and 26 text slots: 425 984 positions a
    side. 2 x (768 x 425 984 x 4 B + 425 984 x 8 B) = 2.624 GB, 0.783 ms
    at 3.35 TB/s."""
    traffic = spec.load_cell(CELL).traffic
    windows = yardstick.unit_windows(serve_batch, traffic)
    assert windows == 96
    want = 2 * (768 * 425_984 * 4 + 425_984 * 8)
    assert want == 2_624_061_440
    got = spec.plugin("metrics", "segmin_roofline").unit_bytes(_cfg(VQ),
                                                               windows)
    assert got == want
    assert got / 3.35e12 == pytest.approx(0.783e-3, rel=1e-3)


def _ctx(kernels, config=VQ, model="vq_wav2vec"):
    return devtrace.TraceContext(
        cell=CELL, config=_cfg(config), traffic=spec.load_cell(CELL).traffic,
        device_name="NVIDIA H100", peaks=yardstick.H100_SXM, units=2,
        window=(0.0, 1.0), kernels=kernels,
        model=spec.plugin("models", model), entry=serve_batch)


def test_share_is_100_where_k7_takes_the_bound():
    least = 2 * 2_624_061_440 / 3.35e12          # two batches
    kernels = [
        devtrace.Kernel("void (anonymous namespace)::segmin_pass_kernel"
                        "<int>(int const*, long long const*)", 0.0,
                        0.75 * least, "match"),
        devtrace.Kernel("void (anonymous namespace)::segmin_decode_kernel"
                        "<float>(unsigned long long const*)", 0.75 * least,
                        least, "match"),
        devtrace.Kernel("lev_kernel<11>", least, 2 * least, "match")]
    read = spec.reader("segmin_roofline.batch")
    assert read(_ctx(kernels)) == pytest.approx(100.0)
    assert read(_ctx(kernels[2:])) is None       # the parent: no K7 kernel
    assert read(_ctx(kernels, "wavlm-large-j1024", "wavlm")) is None
