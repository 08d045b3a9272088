"""WavLM: the port's modules against the JAX package's, with the same
weights carried across (the port's state dict through the JAX package's
own ``convert_wavlm``, and JAX parameters through the port's
``wavlm_state_dict_from_jax``), on the same seeded wavs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpgesture_tpu.models import wavlm as jw
from qpgesture_tpu_torch.models import wavlm as pw
from qpgesture_tpu_torch.models.convert import wavlm_state_dict_from_jax
from qpgesture_tpu_torch.ops import flash_attention_cuda

# tests/test_wavlm.py's small model
SMALL = dict(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
             encoder_attention_heads=4, num_buckets=32, max_distance=80,
             conv_feature_layers=((32, 10, 5), (32, 3, 2), (32, 3, 2)))
STYLES = {
    "large_style": dict(extractor_mode="layer_norm", conv_bias=True,
                        layer_norm_first=True, normalize=True),
    "base_style": dict(extractor_mode="default", conv_bias=False,
                       layer_norm_first=False, normalize=False),
}
# Features: float32 on both sides, other summation orders through 2 layers
# and their LayerNorm chains; the variance is E[x^2] - E[x]^2 in flax and
# two-pass in torch. 2e-4 on features of unit scale.
FEAT_ATOL = 2e-4


def _configs(style, **over):
    kw = {**SMALL, **STYLES[style], **over}
    return jw.WavLMJaxConfig(scan_layers=False, **kw), pw.WavLMConfig(**kw)


def _port_model(pcfg, seed=3):
    torch.manual_seed(seed)
    model = pw.WavLM(pcfg, device="cpu")
    # amplify the gate projection: at random init grep_linear gives ~0 and
    # the gate is ~constant for any input (tests/test_wavlm.py:75-82)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "grep_linear" in name:
                p.mul_(8.0)
    return model


def _wav(seed=0, B=2, n=3200):
    return (np.random.RandomState(seed).randn(B, n) * 0.2).astype(np.float32)


@pytest.mark.parametrize("T,nb,md", [(199, 320, 800), (1200, 320, 800),
                                     (40, 32, 80), (300, 320, 1280)])
def test_relative_position_bucket_bit_equal(T, nb, md):
    pos = np.arange(T)
    rel = pos[None, :] - pos[:, None]
    got = pw.relative_position_bucket(rel, nb, md)
    want = jw.relative_position_bucket(rel, nb, md)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["eager", "flash"])
def test_attention_matches_jax(impl):
    """One attention layer with amplified grep_linear and bias table: the
    gate must come from the raw per-head hidden state."""
    D, H, T, B = 64, 4, 23, 2
    jcfg, pcfg = _configs("large_style", attn_impl=impl)
    torch.manual_seed(5)
    attn = pw.WavLMAttention(pcfg, has_bias_table=True)
    with torch.no_grad():
        attn.grep_linear.weight.mul_(5.0)
        attn.grep_linear.bias.mul_(5.0)
        attn.grep_a.copy_(torch.rand(1, H, 1, 1) + 0.5)
    sd = {k: v.numpy() for k, v in attn.state_dict().items()}
    params = {n: {"kernel": sd[f"{n}.weight"].T, "bias": sd[f"{n}.bias"]}
              for n in ("q_proj", "k_proj", "v_proj", "out_proj",
                        "grep_linear")}
    params["grep_a"] = sd["grep_a"]
    params["rel_bias"] = sd["relative_attention_bias.weight"]
    x = np.random.RandomState(11).randn(B, T, D).astype(np.float32)
    want, want_bias = jw.WavLMAttention(jcfg, has_bias_table=True).apply(
        {"params": params}, jnp.asarray(x), None)
    before = flash_attention_cuda.launches
    got, got_bias = attn(torch.from_numpy(x), None)
    assert flash_attention_cuda.launches == before
    np.testing.assert_array_equal(got_bias.detach().numpy(),
                                  np.asarray(want_bias))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("style", sorted(STYLES))
@pytest.mark.parametrize("impl", ["eager", "flash"])
def test_wavlm_matches_jax(style, impl):
    """A random port WavLM, mapped into flax with the JAX package's own
    converter (so the port's parameter names are Microsoft's)."""
    jcfg, pcfg = _configs(style, attn_impl=impl)
    model = _port_model(pcfg)
    variables = jw.convert_wavlm(model.state_dict(), jcfg)
    wav = _wav()
    want = np.asarray(jw.WavLMJax(jcfg).apply(variables, jnp.asarray(wav)))
    got = model(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 159, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
    # output_layer: the first n layers, without the final LayerNorm
    want1 = np.asarray(jw.WavLMJax(jcfg).apply(variables, jnp.asarray(wav),
                                                output_layer=1))
    got1 = model(torch.from_numpy(wav), output_layer=1).numpy()
    np.testing.assert_allclose(got1, want1, rtol=0, atol=FEAT_ATOL)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_state_dict_from_jax_parameters(scan_layers):
    """JAX-initialised parameters (scanned or unrolled layers) through the
    port's converter: the port computes the JAX model's features."""
    import jax
    jcfg, pcfg = _configs("large_style", encoder_layers=3)
    jcfg = dataclasses.replace(jcfg, scan_layers=scan_layers)
    wav = _wav(seed=1)
    variables = jw.WavLMJax(jcfg).init(jax.random.PRNGKey(0),
                                        jnp.asarray(wav[:1]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = pw.WavLM(pcfg, device="cpu")
    model.load_state_dict(wavlm_state_dict_from_jax(variables, pcfg))
    want = np.asarray(jw.WavLMJax(jcfg).apply(variables, jnp.asarray(wav)))
    got = model(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)


def test_checkpoint_round_trip(tmp_path):
    """A Microsoft-layout {"cfg", "model"} checkpoint loads into the port
    with every tensor in place; extra keys (mask_emb) are ignored. The
    conv stack is WavLM's own: like the JAX loader, the port does not read
    conv_feature_layers from the checkpoint."""
    _, pcfg = _configs("large_style")
    pcfg = dataclasses.replace(pcfg, conv_feature_layers=pw.WavLMConfig()
                               .conv_feature_layers)
    model = _port_model(pcfg)
    sd = dict(model.state_dict(), mask_emb=torch.zeros(64))
    cfg_dict = {k: v for k, v in dataclasses.asdict(pcfg).items()
                if k != "conv_feature_layers"}
    path = str(tmp_path / "wavlm.pt")
    torch.save({"cfg": cfg_dict, "model": sd}, path)
    loaded = pw.load_wavlm_checkpoint(path, device="cpu")
    assert loaded.cfg == pcfg
    wav = torch.from_numpy(_wav(seed=2))
    assert torch.equal(loaded(wav), model(wav))
    with pytest.raises(KeyError, match="lacks"):
        torch.save({"cfg": cfg_dict, "model": {}}, path)
        pw.load_wavlm_checkpoint(path, device="cpu")


def test_precisions_not_ported_raise():
    """Every precision of the JAX package is ported; any other name is
    refused."""
    assert pw.PRECISIONS == tuple(jw._PRECISIONS)
    for prec in pw.PRECISIONS:
        pw.WavLM(_configs("large_style", precision=prec)[1], device="cpu")
    _, pcfg = _configs("large_style", precision="fastest")
    with pytest.raises(ValueError, match="fastest"):
        pw.WavLM(pcfg, device="cpu")


def _bf16_np(x):
    """x rounded to bfloat16 (nearest even) and widened to float32."""
    return np.asarray(x, np.float32).astype(jnp.bfloat16).astype(np.float32)


def test_default_linear_matches_rounded_reference():
    """The CPU "default" Linear: bfloat16-rounded operands multiplied with
    float32 sums, plus the float32 bias. Against numpy on the same rounded
    operands within 1e-6 (float32 summation order only)."""
    torch.manual_seed(0)
    layer = torch.nn.Linear(64, 48)
    x = np.random.RandomState(1).randn(5, 7, 64).astype(np.float32)
    got = pw.linear(layer, torch.from_numpy(x), "default").detach().numpy()
    w = layer.weight.detach().numpy().copy()
    want = (_bf16_np(x) @ _bf16_np(w).T + layer.bias.detach().numpy())
    assert got.dtype == np.float32 and got.shape == (5, 7, 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the bfloat16 copy of the weight is remade after an in-place change
    with torch.no_grad():
        layer.weight.mul_(2.0)
    got2 = pw.linear(layer, torch.from_numpy(x), "default").detach().numpy()
    want2 = (_bf16_np(x) @ _bf16_np(2 * w).T + layer.bias.detach().numpy())
    np.testing.assert_allclose(got2, want2, rtol=0, atol=1e-6)


@pytest.mark.parametrize("style", sorted(STYLES))
@torch.no_grad()
def test_default_convs_match_rounded_reference(style):
    """The "default" convolutions (GEMMs over unfolded windows, channels
    last) against torch's float64 convolutions of the same bfloat16-rounded
    operands, block by block on the same input; the rest of each block
    (norm, GELU) is float32 in both. 1e-5: float32 sums of up to 8192
    exact products against float64."""
    _, pcfg = _configs(style, precision="default")
    model = _port_model(pcfg)
    x = torch.from_numpy(_wav())[:, :, None]
    for block in model.feature_extractor.conv_layers:
        got = pw.conv_block_bf16(block, x)
        conv, _, norm, act = block
        y = torch.nn.functional.conv1d(
            x.transpose(1, 2).bfloat16().double(),
            conv.weight.bfloat16().double(), stride=conv.stride).float()
        if conv.bias is not None:
            y = y + conv.bias[:, None]
        want = act(norm(y)).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)
        x = got
    assert x.shape == model.feature_extractor(
        torch.from_numpy(_wav())).shape

    pos = model.encoder.pos_conv[0]
    feats = torch.from_numpy(np.random.RandomState(2).randn(
        2, 23, 64).astype(np.float32))
    got = pos.forward_bf16(feats)
    want = torch.nn.functional.conv1d(
        feats.transpose(1, 2).bfloat16().double(),
        pos.weight().detach().bfloat16().double(), pos.bias.double(),
        padding=pos.padding, groups=pos.groups)[..., :23].transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


# "default" against the JAX package's "default" with attn_impl="flash" (the
# Pallas kernel in interpret mode, bfloat16). On a CPU XLA computes every
# other DEFAULT contraction in float32, while the port rounds their
# operands to bfloat16 as a TPU does: ~10 chained contractions of operands
# 2^-9 apart, through two layers and their LayerNorms. 8e-2 on features of
# scale ~4 (0.025-0.036 seen; "default" and "highest" of the port differ
# by as much).
@pytest.mark.parametrize("style", sorted(STYLES))
@pytest.mark.parametrize("impl", ["eager", "flash"])
def test_wavlm_default_matches_jax(style, impl):
    jcfg, pcfg = _configs(style, precision="default", attn_impl=impl)
    jcfg = dataclasses.replace(jcfg, attn_impl="flash")
    model = _port_model(pcfg)
    variables = jw.convert_wavlm(model.state_dict(), jcfg)
    wav = _wav()
    want = np.asarray(jw.WavLMJax(jcfg).apply(variables, jnp.asarray(wav)))
    before = flash_attention_cuda.launches
    got = model(torch.from_numpy(wav)).numpy()
    assert flash_attention_cuda.launches == before
    assert got.shape == want.shape == (2, 159, 64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=8e-2)


def _split_np(x):
    """numpy bf16x3 operand split: (hi, lo) as float64."""
    hi = _bf16_np(x)
    return hi.astype(np.float64), _bf16_np(
        np.asarray(x, np.float32) - hi).astype(np.float64)


def _bf16x3_np(a, b):
    """a @ b as bf16x3 computes it, the products and sums in float64."""
    (ah, al), (bh, bl) = _split_np(a), _split_np(b)
    return ah @ bh + (ah @ bl + al @ bh)


def test_high_linear_matches_bf16x3_reference():
    """The CPU "high" Linear: three products of bfloat16 hi/lo splits with
    float32 sums, plus the float32 bias, within 1e-6 of numpy's float64
    bf16x3 on the same splits (float32 summation order only); the dropped
    lo.lo term and the split keep it ~1e-5 from the float32 product."""
    torch.manual_seed(0)
    layer = torch.nn.Linear(64, 48)
    x = np.random.RandomState(1).randn(5, 7, 64).astype(np.float32)
    got = pw.linear(layer, torch.from_numpy(x), "high").detach().numpy()
    w = layer.weight.detach().numpy().copy()
    b = layer.bias.detach().numpy()
    want = _bf16x3_np(x, w.T) + b
    assert got.dtype == np.float32 and got.shape == (5, 7, 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    f32 = x @ w.T + b
    assert 1e-7 < np.abs(got - f32).max() < 1e-4
    # the cached hi/lo copies follow an in-place change of the weight
    with torch.no_grad():
        layer.weight.mul_(2.0)
    got2 = pw.linear(layer, torch.from_numpy(x), "high").detach().numpy()
    np.testing.assert_allclose(got2, _bf16x3_np(x, 2 * w.T) + b, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("style", sorted(STYLES))
@torch.no_grad()
def test_high_convs_match_bf16x3_reference(style):
    """The "high" convolutions (three GEMMs over unfolded windows) against
    numpy's float64 bf16x3 of the same windows, before the block's norm,
    within 1e-6 relative (outputs up to ~4, float32 sums of up to 2048
    products); the pos_conv the same over its groups."""
    _, pcfg = _configs(style, precision="high")
    model = _port_model(pcfg)
    x = torch.from_numpy(_wav())[:, :, None]
    for block in model.feature_extractor.conv_layers:
        conv = block[0]
        k, stride = conv.kernel_size[0], conv.stride[0]
        cols = x.unfold(1, k, stride).reshape(-1, conv.in_channels * k)
        w = conv.weight.reshape(conv.out_channels, -1).t()
        got = pw.matmul_weight(conv, cols, "weight", lambda: w, "high")
        want = _bf16x3_np(cols.numpy(), w.numpy())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        x = pw.conv_block_bf16(block, x, "high")
    assert x.shape == model.feature_extractor(
        torch.from_numpy(_wav())).shape

    pos = model.encoder.pos_conv[0]
    feats = torch.from_numpy(np.random.RandomState(2).randn(
        2, 23, 64).astype(np.float32))
    got = pos.forward_bf16(feats, "high") - pos.bias
    G, k = pos.groups, pos.weight_v.shape[-1]
    cols = torch.nn.functional.pad(feats, (0, 0, pos.padding, pos.padding)
                                   ).unfold(1, k, 1)[:, :23]
    cols = cols.reshape(2 * 23, G, -1).transpose(0, 1).numpy()
    w = pos.weight().reshape(G, 64 // G, -1).transpose(1, 2).numpy()
    want = np.stack([_bf16x3_np(cols[g], w[g]) for g in range(G)])
    want = want.transpose(1, 0, 2).reshape(2, 23, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# "high" against the JAX package's "high". On a CPU XLA computes HIGH in
# float32; the port computes bf16x3 as a TPU does, ~1e-5 relative per
# contraction (the split and the dropped lo.lo term), through two layers
# and their LayerNorms: 4.9e-5-5.4e-5 seen on features of scale ~3.7. The
# tolerance is FEAT_ATOL, the one "highest" is held to.
@pytest.mark.parametrize("style", sorted(STYLES))
@pytest.mark.parametrize("impl", ["eager", "flash"])
def test_wavlm_high_matches_jax(style, impl):
    jcfg, pcfg = _configs(style, precision="high", attn_impl=impl)
    model = _port_model(pcfg)
    variables = jw.convert_wavlm(model.state_dict(), jcfg)
    wav = _wav()
    want = np.asarray(jw.WavLMJax(jcfg).apply(variables, jnp.asarray(wav)))
    before = flash_attention_cuda.launches
    got = model(torch.from_numpy(wav)).numpy()
    assert flash_attention_cuda.launches == before
    assert got.shape == want.shape == (2, 159, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
    highest = _port_model(dataclasses.replace(pcfg, precision="highest"))
    assert np.abs(got - highest(torch.from_numpy(wav)).numpy()).max() > 0
