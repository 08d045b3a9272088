"""The yardstick's counts on hand-computed shapes, the union of intervals,
and the trace reader on a hand-built trace."""
import json
import os

import pytest

from benchmark import devtrace, spec, yardstick
from benchmark.reference import matching

HERE = os.path.dirname(os.path.abspath(__file__))


def _cfg(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_k2_work_main_path_shape():
    ops, nbytes = yardstick.k2_work(6, 16, 199, 64)
    assert ops == 4 * 6 * 16 * 199 * 199 * 64 == 973_234_176
    # q, k, v, the output (B H T hd each), the gate (B H T), the bias (H T T)
    elems = 4 * 6 * 16 * 199 * 64 + 6 * 16 * 199 + 16 * 199 * 199
    assert nbytes == 4 * elems == 22_173_376
    least = yardstick.least_seconds(ops, nbytes, 495e12, 3.35e12)
    assert least == pytest.approx(22_173_376 / 3.35e12)   # bytes bound


def test_k1_work_main_path_shape():
    cells, nbytes = yardstick.k1_work(48, 26624, 11)
    assert cells == 48 * 26624 * 121 == 154_632_192
    assert nbytes == 4 * (48 * 11 + 26624 * 11 + 48 * 26624)
    rate = yardstick.k1_cells_per_s(yardstick.H100_SXM)
    assert rate == 2 * 128 * 132 * 1.98e9
    least = yardstick.least_seconds(cells, nbytes, rate, 3.35e12)
    assert least == pytest.approx(cells / rate)            # ops bound


def test_peaks_only_for_the_sxm_part():
    assert yardstick.peaks("NVIDIA H100 80GB HBM3")["tf32_flops"] == 495e12
    assert yardstick.peaks("NVIDIA H100 PCIe") is None
    assert yardstick.peaks("cpu") is None


def test_wavlm_flops_by_hand():
    c = _cfg("wavlm-large-j1024")
    assert yardstick.conv_frames(c, 64000) == 199
    dense, attn = yardstick.wavlm_flops(c, 1, 64000)
    conv = 2 * (1 * 10 * 512 * 12799 + 512 * 3 * 512 * (6399 + 3199 + 1599
                                                         + 799)
                + 512 * 2 * 512 * (399 + 199))
    proj = 2 * 199 * 512 * 1024
    pos = 2 * 199 * 1024 * 64 * 128
    layers = 24 * (2 * 199 * (4 * 1024 * 1024 + 2 * 1024 * 4096)
                   + 2 * 199 * 16 * 64 * 8)
    assert dense == conv + proj + pos + layers
    assert attn == 24 * 4 * 16 * 199 * 199 * 64


def test_vq_wav2vec_flops_by_hand():
    c = _cfg("vq-wav2vec-j16384")
    T = [12799, 3198, 1598, 798, 398]
    conv = 2 * (10 * 512 * T[0] + 512 * 8 * 512 * T[1]
                + 512 * 4 * 512 * (T[2] + T[3] + T[4])
                + 3 * 512 * 1 * 512 * T[4])       # the recipe's 1 x 1 convs
    proj = 2 * 398 * (512 * 1024 + 1024 * 640)
    assert yardstick.vq_wav2vec_flops(c, 2, 64000) == 2 * (conv + proj)


def test_decode_flops_by_hand():
    v = _cfg("wavlm-large-j1024")["vqvae"]
    L, w = 180, 512
    f = 2 * L * 512 * w * 3
    for _ in range(3):
        f += 3 * (2 * L * w * w * 3 + 2 * L * w * w) + 2 * L * w * 512 * 4
        L *= 2
    f += 2 * L * 512 * 135 * 3
    assert yardstick.vqvae_decode_flops(v, 1, 180) == f


def test_unit_flops_adds_the_parts():
    c = _cfg("wavlm-large-j1024")
    t = {"entry": "serve", "windows": 6, "samples": 64000}
    g = matching.geometry("wavlm_feat")
    slots, _ = matching.text_slots()
    assert (len(g.step_frame), len(g.block_code), len(slots)) == (8, 26, 26)
    Q = 6 * 8
    want = (sum(yardstick.wavlm_flops(c, 6, 64000))
            + 2 * Q * 1024 * 26 * 384 + 2 * Q * 1024 * 26 * 6144
            + yardstick.vqvae_decode_flops(c["vqvae"], 1, 180))
    model, entry = spec.plugin("models", "wavlm"), spec.plugin("entries",
                                                                 "serve")
    assert yardstick.unit_flops(c, model, entry, t, 8, 26, 26) == want


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert yardstick.union_seconds(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert yardstick.union_seconds(iv, 0.5, 3.5) == pytest.approx(2.0)
    assert yardstick.idle_gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert yardstick.union_seconds([], 0.0, 1.0) == 0.0


def _ev(name, ts, dur, cat="kernel", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _mark(k, ts):
    return _ev("Memcpy DtoD (Device -> Device)", ts, 1, "gpu_memcpy",
               bytes=devtrace.mark_bytes(k))


ISSUED = [["start", "enc_start", "enc_end", "dec_start", "dec_end", "end"]]


def _events():
    return [
        _mark(0, 0), _ev("h2d", 2, 3, "gpu_memcpy", bytes=4096),
        _mark(1, 10), _ev("gemm", 11, 20), _mark(2, 40),
        _ev("lev_kernel<11>", 41, 5), _ev("gather", 100, 5),
        _mark(3, 200), _ev("conv", 201, 9), _mark(4, 210),
        _mark(5, 230),
        _ev("odd copy", 300, 1, "gpu_memcpy", bytes=devtrace.mark_bytes(9)),
        {"ph": "i", "name": "ignored", "ts": 5},
    ]


def test_trace_stages_marks_and_breakdown():
    kernels, marks, lost = devtrace.parse({"traceEvents": _events()}, ISSUED)
    assert lost == 0
    assert [(k.name, k.stage) for k in kernels] == [
        ("h2d", "unit"), ("gemm", "encoder"), ("lev_kernel<11>", "match"),
        ("gather", "match"), ("conv", "decode"), ("odd copy", "client")]
    assert marks[0]["enc_end"] == pytest.approx(40e-6)
    ctx = devtrace.TraceContext(
        cell="c", config={}, traffic={}, device_name="x", peaks=None,
        units=1, window=(0.0, 230e-6), kernels=kernels, marks=marks)
    assert ctx.busy_s() == pytest.approx(42e-6)
    assert ctx.kernel_seconds(stage="match") == pytest.approx(10e-6)
    assert ctx.kernel_seconds(name_has="lev_kernel") == pytest.approx(5e-6)
    b = devtrace.breakdown(ctx)
    assert b["device_ops"][0] == ["gemm", pytest.approx(20e-6)]
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    # a gap counts for the stage of the work that ends it
    want = {"unit": 2, "encoder": 6, "match": 10 + 54, "decode": 96,
            "client": 20}
    assert gaps == {k: pytest.approx(v * 1e-6) for k, v in want.items()}
    assert sum(gaps.values()) == pytest.approx(230e-6 - 42e-6)


def test_trace_tolerates_lost_marks():
    """A mark the trace lost is counted; the marks after it keep their
    names, and the stage before it runs on."""
    events = [e for e in _events() if e.get("args", {}).get("bytes")
              != devtrace.mark_bytes(2)]
    kernels, marks, lost = devtrace.parse({"traceEvents": events}, ISSUED)
    assert lost == 1 and "enc_end" not in marks[0]
    assert marks[0]["dec_start"] == pytest.approx(200e-6)
    assert [k.stage for k in kernels][:4] == ["unit", "encoder", "encoder",
                                              "encoder"]
