"""Kernel K5's wrapper on the CPU (ops/groupnorm_cuda.py): the plain path
is bit for bit nn.GroupNorm(1, C) and the activation, vq-wav2vec's
feature extractor keeps its fairseq parameter names and its values, the
wrapper refuses what the kernel does not take, the tiling covers each
window, no launch is counted on the CPU, and `cli warmup` builds K5 with
every other kernel source. The kernel itself is held to the plain version
on the card (tests/test_torch_cuda.py)."""
import argparse
import importlib
import pathlib

import pytest
import torch
from torch import nn

from qpgesture_tpu_torch.models.vq_wav2vec import (VQW2VFeatureExtractor,
                                                   VQWav2VecConfig)
from qpgesture_tpu_torch import cli, device
from qpgesture_tpu_torch.ops import cuda_build, groupnorm_cuda
from qpgesture_tpu_torch.utils import profiling

SMALL = VQWav2VecConfig(conv_layers=((16, 10, 5), (16, 8, 4), (16, 4, 2),
                                     (16, 1, 1)))


def _inputs(B, C, T, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, C, T, generator=g) * 3.0 + 0.5
    return (x, 1.0 + 0.1 * torch.randn(C, generator=g),
            0.1 * torch.randn(C, generator=g))


@pytest.mark.parametrize("T", [1, 7, 399])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_plain_path_is_groupnorm_then_activation(activation, T):
    x, w, b = _inputs(3, 32, T, seed=T)
    norm = nn.GroupNorm(1, 32, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
        act = nn.GELU() if activation == "gelu" else nn.ReLU()
        want = act(norm(x))
    before = groupnorm_cuda.launches
    got = groupnorm_cuda.groupnorm1_act(x, w, b, 1e-5, activation)
    assert groupnorm_cuda.launches == before
    assert torch.equal(got, want)


def _extract_as_modules(fe, wav):
    """The forward as it ran each block's Sequential, before K5."""
    x = wav[:, None, :]
    for block in fe.conv_layers:
        x = block(x)
    return torch.log1p(x.abs()).transpose(1, 2)


def test_feature_extractor_keeps_names_and_values():
    torch.manual_seed(4)
    fe = VQW2VFeatureExtractor(SMALL).eval()
    want_keys = [f"conv_layers.{i}.{p}" for i in range(4)
                 for p in ("0.weight", "2.weight", "2.bias")]
    assert list(fe.state_dict()) == want_keys
    with torch.no_grad():
        for i in range(4):
            fe.conv_layers[i][2].weight.uniform_(0.5, 1.5)
            fe.conv_layers[i][2].bias.uniform_(-0.2, 0.2)
        wav = torch.randn(2, 6400, generator=torch.Generator().manual_seed(5))
        assert torch.equal(fe(wav), _extract_as_modules(fe, wav))


@pytest.mark.parametrize("case", ["not contiguous", "float64", "float16",
                                  "2-D", "weight shape", "activation"])
def test_wrapper_refuses_misuse(case):
    x, w, b = _inputs(2, 8, 12)
    act = "gelu"
    err = ValueError
    if case == "not contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case in ("float64", "float16"):
        x, err = x.to(getattr(torch, case)), TypeError
    elif case == "2-D":
        x = x[0]
    elif case == "weight shape":
        w = w[:4]
    else:
        act = "swish"
    with pytest.raises(err):
        groupnorm_cuda.groupnorm1_act(x, w, b, 1e-5, act)


@pytest.mark.parametrize("B,T,tiles", [(6, 12799, 352), (96, 12799, 22),
                                       (6, 398, 50), (96, 398, 22),
                                       (1, 1, 1), (2, 7, 1)])
def test_tiling_covers_each_window(monkeypatch, B, T, tiles):
    """vq-wav2vec's first and last layer shapes at a clip's 6 and a batch's
    96 windows on a 132-SM card: chunks of a multiple of 4 elements, none
    empty, the last reaching the window's end."""
    dev = torch.device("cuda", 0)
    monkeypatch.setitem(groupnorm_cuda._sms, dev, 132)
    n = 512 * T
    got, chunk = groupnorm_cuda.tiling(B, n, dev)
    assert got == tiles and chunk % 4 == 0
    assert (got - 1) * chunk < n <= got * chunk


def test_no_kernel_counted_on_the_cpu():
    torch.manual_seed(6)
    fe = VQW2VFeatureExtractor(SMALL).eval()
    wav = torch.randn(1, 6400)
    before = groupnorm_cuda.launches
    with profiling.recording() as prof:
        with profiling.span("encode"):
            with torch.no_grad():
                fe(wav)
    assert groupnorm_cuda.launches == before
    assert prof.take()[0]["counters"] == {}


def test_warmup_builds_every_kernel_source(monkeypatch):
    """warmup on a card builds the source of each ops/*_cuda.py wrapper
    (K5's among them), so no kernel is left to nvcc in a serving
    process."""
    ops_dir = pathlib.Path(cuda_build.__file__).parent
    wrapped = sorted(importlib.import_module(
        f"qpgesture_tpu_torch.ops.{p.stem}").SOURCE
        for p in ops_dir.glob("*_cuda.py"))
    assert groupnorm_cuda.SOURCE in wrapped

    class Built(Exception):
        pass

    def build_all(sources):
        raise Built(sorted(sources))

    monkeypatch.setattr(device, "resolve_device",
                        lambda _: torch.device("cuda", 0))
    monkeypatch.setattr(cuda_build, "build_all", build_all)
    with pytest.raises(Built) as built:
        cli.cmd_warmup(argparse.Namespace(device="cuda"))
    assert built.value.args[0] == wrapped
