"""The w2v-BERT 2.0 cell on the CPU: the plug-in's weight names load into
the program, a rehearsal of the cell is correct and its TF32 control is
not, the encoder's and K4's counted work on hand-computed shapes, and K4's
roofline reader on a hand-built trace."""
import json
import os

import pytest
import torch

from benchmark import control, devtrace, harness, spec, system, yardstick
from benchmark.entries import tick

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "w2v-bert-2.0-j1024.pool16"


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model():
    return spec.plugin("models", "w2v_bert")


def _cfg(rehearsal=False):
    with open(os.path.join(HERE, "configs", "w2v-bert-2.0-j1024.json")) as f:
        c = json.load(f)
    return spec.merge(c, c["rehearsal"]) if rehearsal else c


def test_weight_names_load_into_the_program():
    c = _cfg(rehearsal=True)
    m = _model().program(c, "cpu")
    m.load_state_dict(system.encoder_weights(c, _model(), 3, "cpu"),
                      strict=True)


def test_rehearsal_is_correct(capsys):
    rc = harness.main(["--workload", CELL, "--seed", str(2 ** 31 + 7),
                       "--seconds", "0.5", "--trace", "0", "--rehearse"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and r["correct"] and r["failed"] == 0
    assert r["metrics"] == {"tick_p95_ms": "not measured",
                            "setup_s": "not measured"}
    assert set(r["checks"]) == {"enc_rel_err", "code_diff", "phase_err"}


def test_control_fails_at_rehearsal_sizes():
    r = control.readings(CELL, 2 ** 31 + 78, rehearse=True)
    assert r["control_correct"] is False
    assert r["enc_rel_err"] > spec.load_cell(CELL).limits["enc_rel_err"]


def test_work_of_a_window():
    """The sizing at T = 199: 9.6 GFLOP a layer outside attention, K4's
    4.6 GFLOP over 24 layers, ~235 GFLOP a window."""
    c, m = _cfg(), _model()
    assert m.frames(c, 64000) == 199
    assert m.relkey(c, 64000) == (24, 16, 199, 64, 73)
    ops, nbytes = m.relkey_work(16, 16, 199, 64, 73)
    assert ops == 4 * 16 * 16 * 199 * 199 * 64 + 2 * 16 * 16 * 199 * 73 * 64
    assert nbytes == 4 * (4 * 16 * 16 * 199 * 64 + 73 * 64)
    assert 24 * m.relkey_work(1, 16, 199, 64, 73)[0] == pytest.approx(
        4.6e9, rel=0.01)
    assert m.flops(c, 1, 64000) == pytest.approx(235e9, rel=0.01)
    assert m.flops(c, 16, 64000) == 16 * m.flops(c, 1, 64000)
    assert m.attention(c, 64000) is None      # K2's reader stays away


def test_relkey_roofline_on_a_hand_built_trace():
    c, m = _cfg(), _model()
    traffic = spec.load_cell(CELL).traffic
    name = "void relkey_flash_kernel_f32<64>(float const*)"
    kernels = [devtrace.Kernel(name, 0.0, 1e-3, "encoder"),
               devtrace.Kernel("gemm", 1e-3, 2e-3, "encoder")]
    ctx = devtrace.TraceContext(
        cell=CELL, config=c, traffic=traffic, device_name="NVIDIA H100",
        peaks=yardstick.H100_SXM, units=2, window=(0.0, 2e-3),
        kernels=kernels, model=m, entry=tick)
    read = spec.reader("relkey_roofline.tick")
    ops, nbytes = m.relkey_work(16, 16, 199, 64, 73)
    least = 2 * 24 * max(ops / 495e12, nbytes / 3.35e12)
    assert read(ctx) == pytest.approx(100.0 * least / 1e-3)
    wavlm = devtrace.TraceContext(**{**ctx.__dict__,
                                     "model": spec.plugin("models", "wavlm")})
    assert read(wavlm) is None                # no K4 in that encoder
