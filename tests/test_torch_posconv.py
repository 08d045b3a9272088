"""Kernel K6's wrapper on the CPU (ops/posconv_cuda.py): the plain path is
bit for bit WavLM's ``pos_conv`` (conv, SamePad, GELU) and the residual,
and the model's forward is unchanged by it; the packed weight layout
round-trips and is made again after ``load_state_dict``; the wrapper
refuses what the kernel does not take; the frame tile fills the card; no
launch is counted on the CPU; and ``cli warmup`` builds K6 with every other
kernel source. The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py)."""
import argparse

import pytest
import torch

from qpgesture_tpu_torch import cli, device
from qpgesture_tpu_torch.models.wavlm import WavLM, WavLMConfig
from qpgesture_tpu_torch.ops import cuda_build, posconv_cuda
from qpgesture_tpu_torch.utils import profiling

# a 2-layer WavLM of width 64 (4 groups of 16) with WavLM-Large's k = 128
SMALL = WavLMConfig(encoder_layers=2, encoder_embed_dim=64,
                    encoder_ffn_embed_dim=128, encoder_attention_heads=4,
                    num_buckets=32, max_distance=80,
                    conv_feature_layers=((32, 10, 5), (32, 3, 2), (32, 3, 2)),
                    conv_pos_groups=4)


def _model(seed=0):
    torch.manual_seed(seed)
    model = WavLM(SMALL, device="cpu")
    conv = model.encoder.pos_conv[0]
    with torch.no_grad():       # a weight norm and bias away from init
        conv.weight_g.uniform_(0.5, 1.5)
        conv.bias.uniform_(-0.2, 0.2)
    return model


def _feats(B, T, C, seed=1):
    return torch.randn(B, T, C, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("T", [1, 64, 199, 257])
def test_plain_path_is_pos_conv_and_residual(T):
    model = _model()
    conv = model.encoder.pos_conv[0]
    feats = _feats(2, T, 64, seed=T)
    with torch.no_grad():
        want = feats + model.encoder.pos_conv(
            feats.transpose(1, 2)).transpose(1, 2)
        got = posconv_cuda.posconv(feats, conv.packed(), conv.bias)
        plain = posconv_cuda.posconv_plain(feats, conv.weight(), conv.bias,
                                           conv.groups)
    assert got.shape == (2, T, 64)
    assert torch.equal(got, want)
    assert torch.equal(plain, want)


def _forward_as_modules(model, wav):
    """WavLM.forward at "highest" as it ran the pos_conv Sequential and the
    residual before K6."""
    enc = model.encoder
    x = wav
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    x = (x - mean) / torch.sqrt(var + 1e-5)
    feats = model.post_extract_proj(
        model.layer_norm(model.feature_extractor(x)))
    x = feats + enc.pos_conv(feats.transpose(1, 2)).transpose(1, 2)
    position_bias = None
    for layer in enc.layers:
        x, position_bias = layer(x, position_bias)
    return enc.layer_norm(x)


def test_wavlm_forward_is_unchanged():
    model = _model(2)
    wav = torch.randn(2, 3200, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert torch.equal(model(wav), _forward_as_modules(model, wav))


def test_packed_weight_round_trips_and_follows_load_state_dict():
    model = _model(4)
    conv = model.encoder.pos_conv[0]
    w = conv.weight().detach()
    G, cg, k = conv.groups, 16, w.shape[-1]
    packed = conv.packed()
    assert packed.shape == (G, k, cg, cg) and packed.is_contiguous()
    assert torch.equal(posconv_cuda.unpack_weight(packed), w)
    g, j, i, o = 3, 100, 5, 11
    assert packed[g, j, i, o] == w[g * cg + o, i, j]
    assert conv.packed() is packed             # cached while unchanged
    other = _model(5)
    model.load_state_dict(other.state_dict())
    fresh = conv.packed()
    want = other.encoder.pos_conv[0].weight().detach()
    assert not torch.equal(fresh, packed)
    assert torch.equal(posconv_cuda.unpack_weight(fresh), want)
    assert torch.equal(fresh, posconv_cuda.pack_weight(want, G))


def _args(case):
    feats = _feats(2, 9, 64)
    packed = posconv_cuda.pack_weight(torch.randn(64, 16, 16), 4)
    bias = torch.randn(64)
    err = ValueError
    if case == "float64":
        feats, err = feats.double(), TypeError
    elif case == "not contiguous":
        feats = feats.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "2-D":
        feats = feats[0]
    elif case == "channels not groups":
        feats = _feats(2, 9, 60)
    elif case == "bias shape":
        bias = bias[:32]
    elif case == "devices":
        bias = bias.to("meta")
    elif case in ("device", "grad on the card"):
        feats, packed, bias = (t.to("meta") for t in (feats, packed, bias))
        if case == "grad on the card":
            bias.requires_grad_(True)
            err = RuntimeError
    return (feats, packed, bias), err


@pytest.mark.parametrize("case", [
    "float64", "not contiguous", "2-D", "channels not groups", "bias shape",
    "devices", "device", "grad on the card"])
def test_wrapper_refuses_misuse(case):
    """The wrapper's checks, before any launch; "grad on the card" stands a
    meta tensor for a CUDA one (the check holds on every device but the
    CPU, whose plain path keeps autograd)."""
    args, err = _args(case)
    with pytest.raises(err):
        posconv_cuda.posconv(*args)


def test_pack_refuses_groups_that_do_not_divide():
    with pytest.raises(ValueError):
        posconv_cuda.pack_weight(torch.randn(64, 16, 128), 3)


def test_launch_refuses_cpu_tensors():
    (feats, packed, bias), _ = _args("none")
    before = posconv_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        posconv_cuda.launch(feats, packed, bias, 64)
    assert posconv_cuda.launches == before


def test_plain_path_keeps_autograd_on_the_cpu():
    (feats, packed, bias), _ = _args("none")
    bias.requires_grad_(True)
    posconv_cuda.posconv(feats, packed, bias).sum().backward()
    assert bias.grad is not None and bias.grad.shape == (64,)


# WavLM-Large (16 groups of 64, k = 128) on a 132-SM card at 199 frames (a
# 4 s window): a pool tick's 16 windows and a clip's 6 take one tile of 224
# (7 warps; 256 blocks, two an SM, or 96, one an SM; 225 / 199 = 13 %
# padded frames), one window two of 128. Measured on an H100 at a tick /
# a clip: 1.42 / 0.72 ms at 224, 1.49 / 0.75 at 128, 2.08 / 0.80 at 64,
# 2.35-2.38 / 1.18-1.19 at 160 and 192, whose 5 and 6 warps load the four
# schedulers unevenly.
@pytest.mark.parametrize("B,T,tile", [(16, 199, 224), (6, 199, 224),
                                      (1, 199, 128), (24, 199, 224),
                                      (16, 257, 128), (16, 1, 128)])
def test_frame_tile_fills_the_card(B, T, tile):
    got = posconv_cuda.frame_tile(B, T, 16, 64, 128, 132)
    assert got == tile
    assert got % 32 == 0 and posconv_cuda.MIN_TILE <= got <= \
        posconv_cuda.MAX_TILE
    assert posconv_cuda.block_smem(got, 64, 128) <= posconv_cuda.MAX_SMEM


def test_two_blocks_of_the_largest_tile_share_an_sm():
    """228 KB of shared memory an SM, 1 KB of it kept for each block."""
    assert 2 * (posconv_cuda.block_smem(224, 64, 128) + 1024) <= 228 * 1024


def test_no_kernel_counted_on_the_cpu():
    model = _model(6)
    wav = torch.randn(1, 3200)
    before = posconv_cuda.launches
    with profiling.recording() as prof:
        with profiling.span("encode"):
            model(wav)
    assert posconv_cuda.launches == before
    assert "posconv_kernel" not in prof.take()[0]["counters"]


def test_cpu_forward_makes_no_packed_weight():
    """On the CPU the forward convolves with the module's own weight: the
    packed copy is made only for the card."""
    model = _model(7)
    conv = model.encoder.pos_conv[0]
    with torch.no_grad():
        model(torch.randn(1, 3200))
    assert not any("packed" in key for key in
                   conv.__dict__.get("_derived_weights", {}))


@pytest.mark.parametrize("cg,k,ok", [(64, 128, True), (48, 128, True),
                                     (64, 64, True), (16, 128, False),
                                     (80, 128, False), (64, 127, False),
                                     (64, 100, False)])
def test_check_shape(cg, k, ok):
    if ok:
        posconv_cuda.check_shape(cg, k)
    else:
        with pytest.raises(ValueError, match="no kernel instantiation"):
            posconv_cuda.check_shape(cg, k)


@pytest.mark.parametrize("precision,raises", [("highest", True),
                                              ("default", False)])
def test_wavlm_on_the_card_refuses_widths_k6_lacks(monkeypatch, precision,
                                                    raises):
    """A WavLM of 4 groups of 16 channels built for the card at "highest"
    raises before a module is made; the bfloat16 paths take any width."""
    import dataclasses

    from qpgesture_tpu_torch.models import wavlm

    class Built(Exception):
        pass

    def encoder(cfg):
        raise Built

    monkeypatch.setattr(wavlm, "resolve_device",
                        lambda _: torch.device("cuda", 0))
    monkeypatch.setattr(wavlm, "ConvFeatureExtractor", encoder)
    cfg = dataclasses.replace(SMALL, precision=precision)
    with pytest.raises(ValueError if raises else Built):
        WavLM(cfg, device="cuda")


def test_warmup_builds_posconv(monkeypatch):
    assert posconv_cuda.SOURCE in cuda_build.all_sources()

    class Built(Exception):
        pass

    def build_all(sources):
        raise Built(sorted(sources))

    monkeypatch.setattr(device, "resolve_device",
                        lambda _: torch.device("cuda", 0))
    monkeypatch.setattr(cuda_build, "build_all", build_all)
    with pytest.raises(Built) as built:
        cli.cmd_warmup(argparse.Namespace(device="cuda"))
    assert posconv_cuda.SOURCE in built.value.args[0]
