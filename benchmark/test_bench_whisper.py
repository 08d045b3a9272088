"""The Whisper-large-v3 cell on the CPU: the plug-in's weight names load
into the program, a rehearsal of the cell is correct and its TF32 control
is not, the encoder's and the bias-free attention's counted work on
hand-computed shapes, and the attention's roofline reader on a hand-built
trace."""
import json
import os

import pytest
import torch

from benchmark import control, devtrace, harness, spec, system, yardstick
from benchmark.entries import serve

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "whisper-large-v3-j1024.clip"


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model():
    return spec.plugin("models", "whisper")


def _cfg(rehearsal=False):
    with open(os.path.join(HERE, "configs",
                           "whisper-large-v3-j1024.json")) as f:
        c = json.load(f)
    return spec.merge(c, c["rehearsal"]) if rehearsal else c


def test_weight_names_load_into_the_program():
    c = _cfg(rehearsal=True)
    m = _model().program(c, "cpu")
    m.load_state_dict(system.encoder_weights(c, _model(), 3, "cpu"),
                      strict=True)


def test_rehearsal_is_correct(capsys):
    rc = harness.main(["--workload", CELL, "--seed", str(2 ** 31 + 11),
                       "--seconds", "0.5", "--trace", "0", "--rehearse"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and r["correct"] and r["failed"] == 0
    assert r["metrics"] == {"clip_p50_ms": "not measured",
                            "clip_p95_ms": "not measured",
                            "setup_s": "not measured"}
    assert set(r["checks"]) == {"enc_rel_err", "code_diff", "pose_err"}


def test_control_fails_at_rehearsal_sizes():
    r = control.readings(CELL, 2 ** 31 + 79, rehearse=True)
    assert r["control_correct"] is False
    assert r["enc_rel_err"] > spec.load_cell(CELL).limits["enc_rel_err"]


def test_reference_refuses_a_block_past_30_s():
    c = _cfg(rehearsal=True)
    w = system.encoder_weights(c, _model(), 3, "cpu")
    with pytest.raises(ValueError, match="more than one 30 s utterance"):
        _model().reference(w, c, torch.zeros(8, 64000))


def test_work_of_a_clip():
    """A 24 s clip is one utterance of 1500 positions: 2.27 TFLOP, of which
    attention 32 x 11.5 GFLOP."""
    c, m = _cfg(), _model()
    assert m.frames(c, 64000) == 200
    assert m.utterances(c, 6, 64000) == 1
    assert m.utterances(c, 8, 64000) == 2
    assert m.attn_shape(c, 6, 64000) == (32, 1, 20, 1500, 64)
    ops, nbytes = m.attn_work(1, 20, 1500, 64)
    assert ops == 4 * 20 * 1500 ** 2 * 64 == pytest.approx(11.52e9)
    assert nbytes == 4 * 4 * 20 * 1500 * 64
    stem = 2 * 3000 * 128 * 3 * 1280 + 2 * 1500 * 1280 * 3 * 1280
    layer = 2 * 1500 * (4 * 1280 ** 2 + 2 * 1280 * 5120) + ops
    assert m.flops(c, 6, 64000) == stem + 32 * layer
    assert m.flops(c, 6, 64000) == pytest.approx(2.27e12, rel=0.005)
    assert m.flops(c, 1, 64000) == m.flops(c, 7, 64000)
    assert m.table_flops(c, 2, 3) == 2.0 * 2 * 3 * 6 * 1280
    assert m.attention(c, 64000) is None      # K2's gated reader stays away


def test_attn_roofline_on_a_hand_built_trace():
    c, m = _cfg(), _model()
    traffic = spec.load_cell(CELL).traffic
    name = "void (anonymous namespace)::nobias_flash_kernel_f32<64, 8>(" \
        "float const*)"
    gated = "void (anonymous namespace)::gated_flash_kernel_f32<64>(" \
        "float const*)"
    kernels = [devtrace.Kernel(name, 0.0, 2e-3, "encoder"),
               devtrace.Kernel(gated, 2e-3, 3e-3, "encoder"),
               devtrace.Kernel("gemm", 3e-3, 4e-3, "encoder")]
    ctx = devtrace.TraceContext(
        cell=CELL, config=c, traffic=traffic, device_name="NVIDIA H100",
        peaks=yardstick.H100_SXM, units=3, window=(0.0, 4e-3),
        kernels=kernels, model=m, entry=serve)
    read = spec.reader("whisper_attn_roofline.clip")
    ops, nbytes = m.attn_work(1, 20, 1500, 64)
    least = 3 * 32 * max(ops / 495e12, nbytes / 3.35e12)
    assert read(ctx) == pytest.approx(100.0 * least / 2e-3)
    assert spec.reader("k2_roofline.clip")(ctx) is None
    wavlm = devtrace.TraceContext(**{**ctx.__dict__,
                                     "model": spec.plugin("models", "wavlm")})
    assert read(wavlm) is None                # no bias-free K2 in WavLM
    none = devtrace.TraceContext(**{**ctx.__dict__, "kernels": kernels[1:]})
    assert read(none) is None                 # the trace holds no such kernel
