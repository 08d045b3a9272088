"""The CPU-safe parts of utils/devtime.py and utils/profiling.py: the phase
profiler's report, mfu, the operation counter (on a conv, on the low-
precision GEMM route, and on a double-backward graph that FlopCounterMode
refuses), and that device timing refuses a machine without a card. The
timing itself runs on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import json
import os
import time

import pytest
import torch
import torch.nn.functional as F

from qpgesture_tpu_torch.models.encdec import Conv1d
from qpgesture_tpu_torch.utils import devtime
from qpgesture_tpu_torch.utils.profiling import (Profiler, block_and_time,
                                                 device_trace)


def test_profiler_nests_and_reports(tmp_path):
    prof = Profiler()
    for _ in range(2):
        with prof.phase("serve"):
            with prof.phase("match"):
                time.sleep(0.002)
    with pytest.raises(RuntimeError):
        with prof.phase("fail"):
            raise RuntimeError("boom")
    report = prof.report()
    assert list(report) == ["fail", "serve", "serve/match"]
    assert report["serve"]["count"] == 2 == report["serve/match"]["count"]
    assert report["serve"]["total_s"] >= report["serve/match"]["total_s"] \
        >= 0.004
    path = str(tmp_path / "prof.json")
    assert json.loads(prof.dump(path)) == json.load(open(path))


def test_block_and_time_and_trace_on_the_cpu(tmp_path):
    out, sec = block_and_time(lambda x: x * 2, torch.ones(3), n=3)
    assert torch.equal(out, torch.full((3,), 2.0)) and sec >= 0
    with device_trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))


def test_mfu_and_peaks():
    assert devtime.mfu(1e12, 0.5, 4e12) == 0.5
    assert devtime.mfu(1e12, 0.5, 0.0) is None
    assert devtime.H100_SXM_PEAKS["bfloat16"] == 989e12
    assert devtime.H100_SXM_PEAKS["float32"] == 67e12
    if not torch.cuda.is_available():
        assert devtime.peak_flops_per_s("float32") == ("cpu", 0.0)


def test_device_timing_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        devtime.device_seconds_per_iter(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        devtime.chained_seconds_per_iter(lambda c: (c,), 0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        devtime.measure_link_s()


@pytest.mark.parametrize("precision", ["highest", "default", "high"])
def test_flops_of_a_conv_forward_and_backward(precision):
    """2 * B * T' * C_out * C_in * k a pass: the forward, and in the
    backward the input and weight gradients (the same count each). bf16x3
    runs three products, so "high" counts three times as many."""
    conv = Conv1d(8, 6, 3, 1, 1, precision=precision)
    x = torch.randn(2, 8, 10, requires_grad=True)
    one = 2 * 2 * 10 * 6 * 8 * 3
    mult = 3 if precision == "high" else 1
    flops, y = devtime.cost_analysis_flops(conv, x)
    assert flops == mult * one
    back, _ = devtime.cost_analysis_flops(lambda: y.sum().backward())
    assert back == 2 * mult * one


def test_flops_of_a_double_backward():
    """A gradient penalty's double backward (autograd.grad with
    create_graph on a leaf input), which FlopCounterMode's module hooks
    refuse: forward, first backward (input gradient only) and the backward
    of that, each a multiple of the conv's count."""
    torch.manual_seed(0)
    conv = torch.nn.Conv1d(4, 4, 3, padding=1)
    x = torch.randn(2, 4, 16, requires_grad=True)
    one = 2 * 2 * 16 * 4 * 4 * 3

    def penalty_step():
        y = F.leaky_relu(conv(x), 0.2).sum()
        (g,) = torch.autograd.grad(y, x, create_graph=True)
        (g.norm() ** 2).backward()

    flops, _ = devtime.cost_analysis_flops(penalty_step)
    assert flops > 2 * one and flops % one == 0
