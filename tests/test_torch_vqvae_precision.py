"""The VQ-VAE below true float32, at more than one level, and from the JAX
package's msgpack files.

XLA on the CPU computes DEFAULT and HIGH contractions in float32, so the
port's "default" (bfloat16 operands) and "high" (bf16x3) convolutions are
held to float64 convolutions of the rounded (or split) operands, and the
whole model to JAX's "highest" within a bound derived from the rounding.
Multi-level encode / decode, ``load_vqvae_native`` and the FGD extractor
file are held to the JAX package itself; ``utils/flax_msgpack`` to
``flax.serialization``.
"""
import os
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

import jax
import jax.numpy as jnp
from flax import serialization

from qpgesture_tpu.core.config import VQVAEConfig
from qpgesture_tpu.models import bottleneck as jbn
from qpgesture_tpu.models.vqvae import VQVAE as JaxVQVAE
from qpgesture_tpu.models.vqvae import save_vqvae_native
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.core.config import VQVAEConfig as PortVQVAEConfig
from qpgesture_tpu_torch.models.convert import (vqvae_state_dict_from_jax,
                                                vqvae_state_dict_to_jax)
from qpgesture_tpu_torch.models.encdec import Conv1d, ConvTranspose1d
from qpgesture_tpu_torch.models.vqvae import VQVAE, load_vqvae_native
from qpgesture_tpu_torch.ops.precision import split_bf16
from qpgesture_tpu_torch.utils import flax_msgpack

SMALL = dict(width=16, emb_width=16, l_bins=32, depth=2, input_dim=18)
T = 48
# one conv against float64 convs of its rounded / split operands: float32
# sums of O(1) products, at most a few dozen terms
CONV_ATOL = 1e-5
# bfloat16 keeps 8 significant bits (unit roundoff 2^-9); bf16x3 drops the
# lo.lo product and rounds lo, at most ~2^-16 of each product
UNIT = {"default": 2.0 ** -9, "high": 2.0 ** -16}


def _ops(x, precision):
    """The operand pairs whose float64 products a conv at ``precision``
    sums: ((hi,),) pairs for "default", bf16x3's three for "high"."""
    if precision == "default":
        return [x.to(torch.bfloat16).double()]
    hi, lo = split_bf16(x)
    return [hi.double(), lo.double()]


def _ref_conv(conv, x, precision):
    """float64 conv of the rounded (split) operands, as the port computes."""
    xs, ws = _ops(x, precision), _ops(conv.weight.detach(), precision)
    pairs = [(0, 0)] if precision == "default" else [(0, 0), (0, 1), (1, 0)]
    if isinstance(conv, ConvTranspose1d):
        op = lambda a, w: F.conv_transpose1d(a, w, None, conv.stride,
                                             conv.padding)
    else:
        op = lambda a, w: F.conv1d(a, w, None, conv.stride, conv.padding,
                                   conv.dilation)
    return sum(op(xs[i], ws[j]) for i, j in pairs) + conv.bias.double()[
        :, None]


def _ref_grads(conv, x, weight, g, precision):
    """float64 (dx, dw) of a conv whose products round x, the weight and
    the upstream gradient g as ``precision`` rounds them."""
    gs, ws, xs = _ops(g, precision), _ops(weight, precision), \
        _ops(x, precision)
    pairs = [(0, 0)] if precision == "default" else [(0, 0), (0, 1), (1, 0)]
    if isinstance(conv, ConvTranspose1d):
        # <conv_transpose(x, w), g> = <x, conv1d(g, w)>
        dx = sum(F.conv1d(gs[i], ws[j], None, conv.stride, conv.padding)
                 for i, j in pairs)
        dw = sum(torch.nn.grad.conv1d_weight(
            gs[j], weight.shape, xs[i], conv.stride, conv.padding)
            for i, j in pairs)
    else:
        dx = sum(torch.nn.grad.conv1d_input(
            x.shape, ws[j], gs[i], conv.stride, conv.padding, conv.dilation)
            for i, j in pairs)
        dw = sum(torch.nn.grad.conv1d_weight(
            xs[i], weight.shape, gs[j], conv.stride, conv.padding,
            conv.dilation) for i, j in pairs)
    return dx, dw


LAYERS = {
    "conv k3 dilation 3": lambda p: Conv1d(12, 10, 3, 1, 3, 3, precision=p),
    "conv k4 stride 2": lambda p: Conv1d(12, 10, 4, 2, 1, precision=p),
    "conv k1": lambda p: Conv1d(12, 10, 1, 1, 0, precision=p),
    "transposed k4 stride 2": lambda p: ConvTranspose1d(12, 10, 4, 2, 1,
                                                        precision=p),
}


@pytest.mark.parametrize("precision", ["default", "high"])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_conv_matches_float64_of_rounded_operands(layer, precision):
    """Forward and both gradients within CONV_ATOL of float64 convs whose
    operands (the upstream gradient too) are rounded as the port rounds
    them: JAX's VJP of a conv keeps its precision."""
    torch.manual_seed(3)
    conv = LAYERS[layer](precision)
    x = torch.randn(2, 12, 17, requires_grad=True)
    y = conv(x)
    ref = _ref_conv(conv, x.detach(), precision)
    assert y.shape == ref.shape and y.dtype == torch.float32
    assert float((y.double() - ref).abs().max()) < CONV_ATOL

    g = torch.randn_like(y)
    y.backward(g)
    dx, dw = _ref_grads(conv, x.detach(), conv.weight.detach(), g, precision)
    assert float((x.grad.double() - dx).abs().max()) < CONV_ATOL
    assert float((conv.weight.grad.double() - dw).abs().max()) < CONV_ATOL
    assert float((conv.bias.grad - g.sum((0, 2))).abs().max()) < CONV_ATOL


def _port_model(seed, precision="highest", **kw):
    torch.manual_seed(seed)
    model = VQVAE(PortVQVAEConfig(**{**SMALL, **kw},
                                  conv_precision=precision), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    model.codebook_block.set_state(torch.randn(model.codebook.shape,
                                               generator=g))
    return model


def _with_precision(model, precision):
    out = VQVAE(PortVQVAEConfig(**{**SMALL},
                                conv_precision=precision), device="cpu")
    out.load_state_dict(model.state_dict())
    out.codebook_block.set_state(model.codebook)
    return out


def _jax(model, cfg_kw=SMALL):
    tree = vqvae_state_dict_to_jax(model.state_dict(),
                                   PortVQVAEConfig(**cfg_kw))
    cb = jbn.CodebookState(k=jnp.asarray(tree["codebook"]["k"]),
                           k_sum=jnp.asarray(tree["codebook"]["k"]),
                           k_elem=jnp.ones(tree["codebook"]["k"].shape[0]))
    return JaxVQVAE(VQVAEConfig(**cfg_kw)), tree["params"], cb


def _n_convs(module):
    return sum(isinstance(m, (Conv1d, ConvTranspose1d))
               for m in module.modules())


@pytest.mark.parametrize("precision", ["default", "high"])
def test_vqvae_at_precision_against_jax_highest(precision):
    """decode and the encoder's embedding at ``precision`` against JAX's
    "highest" (which XLA's CPU also runs for its "default"). Bound: each
    of the n convs on the path rounds the products it sums by at most 2u
    (u = UNIT[precision]) of their size, so the output moves by at most
    n * 2u * max|y| to first order. "default" must also be farther from
    "highest" than float32 summation order explains (10x the port's own
    "highest" gap): the rounding happened."""
    ref = _port_model(0)
    jmodel, params, cb = _jax(ref)
    rng = np.random.RandomState(0)
    codes = rng.randint(0, SMALL["l_bins"], (2, 6))
    x = rng.randn(2, T, SMALL["input_dim"]).astype(np.float32)
    y_jax = np.asarray(jax.jit(jmodel.decode)(params, cb,
                                              jnp.asarray(codes)))
    h_jax = np.asarray(jax.jit(jmodel.encoder.apply)(
        {"params": params["encoder"]}, jnp.asarray(x))[-1])
    model = _with_precision(ref, precision)
    y = model.decode(torch.from_numpy(codes)).numpy()
    with torch.no_grad():
        h = model.encoders[0](torch.from_numpy(x)).numpy()
        h_hi = ref.encoders[0](torch.from_numpy(x)).numpy()
    y_hi = ref.decode(torch.from_numpy(codes)).numpy()
    u = UNIT[precision]
    for got, hi, want, part in ((y, y_hi, y_jax, model.decoders),
                                (h, h_hi, h_jax, model.encoders)):
        bound = _n_convs(part) * 2 * u * float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= bound, (err, bound)
        if precision == "default":
            assert err > 10 * float(np.abs(hi - want).max())


class _RoundedConv(torch.autograd.Function):
    """A conv whose forward and backward are float64 convs of operands
    rounded as ``precision`` rounds them (the upstream gradient too)."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv, precision):
        ctx.conv, ctx.precision = conv, precision
        ctx.save_for_backward(x, weight)
        return _ref_conv(conv, x, precision).float()

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = _ref_grads(ctx.conv, x, weight, g, ctx.precision)
        return dx.float(), dw.float(), g.sum((0, 2)), None, None


def _rounded_reference(model, precision):
    """A copy of ``model`` whose convs run _RoundedConv."""
    import copy
    ref = copy.deepcopy(model)
    for m in ref.modules():
        if isinstance(m, (Conv1d, ConvTranspose1d)):
            m.forward = types.MethodType(
                lambda self, x: _RoundedConv.apply(
                    x, self.weight, self.bias, self, precision), m)
    return ref


@pytest.mark.parametrize("precision", ["default", "high"])
def test_training_step_matches_rounded_reference(precision):
    """One training forward (EMA update on, the same restart draws) and
    backward at ``precision`` against the same step through float64 convs
    of the rounded operands: codes equal, loss within 1e-5 relative, every
    gradient within 1e-4 of its tensor's largest |g| (float32 against
    float64 sums)."""
    model = _with_precision(_port_model(4), precision)
    ref = _rounded_reference(model, precision)
    x = torch.from_numpy(np.random.RandomState(5).randn(
        4, T, SMALL["input_dim"]).astype(np.float32))
    outs = []
    for m in (model, ref):
        g = torch.Generator().manual_seed(9)
        _, loss, metrics = m(x, train=True, generator=g)
        loss.backward()
        outs.append((loss, metrics))
    (loss, met), (loss_ref, met_ref) = outs
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * float(loss_ref)
    for k in ("recons_loss", "commit_loss", "velocity_loss"):
        assert abs(float(met[k]) - float(met_ref[k])) <= \
            1e-5 * abs(float(met_ref[k])) + 1e-9, k
    ref_params = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        want = ref_params[name].grad
        assert float((p.grad - want).abs().max()) <= \
            1e-4 * float(want.abs().max()) + 1e-9, name
    assert torch.equal(model.codebook_block.k_elem, ref.codebook_block.k_elem)


@pytest.mark.parametrize("precision", ["default", "high"])
def test_checkpoint_res_at_precision(precision):
    """checkpoint_res recomputes each residual block at the same precision:
    the gradients equal the stored-activation step's bit for bit."""
    x = torch.from_numpy(np.random.RandomState(6).randn(
        2, T, SMALL["input_dim"]).astype(np.float32))
    grads = []
    for ckpt in (False, True):
        torch.manual_seed(1)
        m = VQVAE(PortVQVAEConfig(**SMALL, conv_precision=precision,
                                  checkpoint_res=ckpt), device="cpu")
        m.codebook_block.set_state(torch.randn(m.codebook.shape))
        m(x)[1].backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


LEVELS2 = dict(SMALL, levels=2, downs_t=(3, 1), strides_t=(2, 2),
               hvqvae_multipliers=(1, 1))


def test_two_levels_encode_decode_match_jax():
    """levels=2, downs_t=(3, 1): encode quantises the deepest level (15
    codes a 240-frame window), bit-equal to JAX's VQVAE.encode; decode runs
    the level-0 decoder (8 frames a code) within 1e-5 of JAX's; the port's
    inverse converter gives JAX's tree back exactly; the training forward
    raises, naming the decoder's 120 frames."""
    jmodel = JaxVQVAE(VQVAEConfig(**LEVELS2))
    params = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.PRNGKey(0))
    x = np.random.RandomState(1).randn(3, 240, 18).astype(np.float32)
    cb = jax.jit(jmodel.init_codebook_from_batch)(params, jnp.asarray(x),
                                                  jax.random.PRNGKey(2))
    cfg = PortVQVAEConfig(**LEVELS2)
    model = VQVAE(cfg, device="cpu")
    model.load_state_dict(vqvae_state_dict_from_jax(params, cb, cfg))
    want = np.asarray(jax.jit(jmodel.encode)(params, cb, jnp.asarray(x)))
    got = model.encode(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 15)
    np.testing.assert_array_equal(got, want)
    y = model.decode(torch.from_numpy(got)).numpy()
    assert y.shape == (3, 120, 18)
    np.testing.assert_allclose(
        y, np.asarray(jax.jit(jmodel.decode)(params, cb, jnp.asarray(want))),
        rtol=0, atol=1e-5)
    back = vqvae_state_dict_to_jax(model.state_dict(), cfg)["params"]
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat.keys() == flat_back.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(v), flat_back[k])
    with pytest.raises(ValueError, match="gives 120 frames from the 15 codes"):
        model(torch.from_numpy(x))


def _jax_trained(tmp_path, cfg_kw):
    """A JAX VQ-VAE with a data-initialized codebook and EMA statistics that
    differ from a fresh start, saved by save_vqvae_native."""
    jmodel = JaxVQVAE(VQVAEConfig(**cfg_kw))
    params = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.PRNGKey(3))
    x = np.random.RandomState(4).randn(4, 48, cfg_kw["input_dim"]
                                       ).astype(np.float32)
    cb = jax.jit(jmodel.init_codebook_from_batch)(params, jnp.asarray(x),
                                                  jax.random.PRNGKey(5))
    cb = jbn.CodebookState(k=cb.k, k_sum=cb.k_sum * 2.0,
                           k_elem=cb.k_elem * 3.0)
    path = str(tmp_path / "vqvae.msgpack")
    save_vqvae_native(path, params, cb)
    return jmodel, params, cb, path


def test_load_vqvae_native_decodes_as_jax(tmp_path):
    """save_vqvae_native (JAX) -> load_vqvae_native (port): decode within
    1e-5 of JAX's, codes bit-equal, EMA statistics exact."""
    jmodel, params, cb, path = _jax_trained(tmp_path, SMALL)
    model = load_vqvae_native(path, PortVQVAEConfig(**SMALL), device="cpu")
    np.testing.assert_array_equal(model.codebook_block.k_sum.numpy(),
                                  np.asarray(cb.k_sum))
    np.testing.assert_array_equal(model.codebook_block.k_elem.numpy(),
                                  np.asarray(cb.k_elem))
    rng = np.random.RandomState(6)
    codes = rng.randint(0, SMALL["l_bins"], (2, 6))
    np.testing.assert_allclose(
        model.decode(torch.from_numpy(codes)).numpy(),
        np.asarray(jax.jit(jmodel.decode)(params, cb, jnp.asarray(codes))),
        rtol=0, atol=1e-5)
    x = rng.randn(2, T, SMALL["input_dim"]).astype(np.float32)
    np.testing.assert_array_equal(
        model.encode(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(jmodel.encode)(params, cb, jnp.asarray(x))))
    with open(str(tmp_path / "bad.msgpack"), "wb") as f:
        f.write(flax_msgpack.pack({"weights": np.zeros(3, np.float32)}))
    with pytest.raises(ValueError, match="not a VQ-VAE msgpack"):
        load_vqvae_native(str(tmp_path / "bad.msgpack"),
                          PortVQVAEConfig(**SMALL), device="cpu")


def test_decode_and_signature_cli_take_a_msgpack(tmp_path):
    """decode and signature through the port's CLI from the JAX package's
    .msgpack file write what they write from the same weights as a
    torch checkpoint."""
    from test_build_db_cli import make_beat_like_bvh
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    from qpgesture_tpu_torch.motion.pipeline import MotionPipeline

    cfg_kw = dict(SMALL, input_dim=135)
    _, _, _, msgpack_path = _jax_trained(tmp_path, cfg_kw)
    model = load_vqvae_native(msgpack_path, PortVQVAEConfig(**cfg_kw),
                              device="cpu")
    bin_path = str(tmp_path / "vqvae.bin")
    torch.save({"model_dict": model.state_dict()}, bin_path)
    config = str(tmp_path / "cfg.yml")
    with open(config, "w") as f:
        yaml.safe_dump({"VQVAE": cfg_kw}, f)
    rng = np.random.RandomState(7)
    pipe = MotionPipeline(fps=60).fit(parse_bvh(make_beat_like_bvh(rng, 300)))
    with open(str(tmp_path / "pipeline.json"), "w") as f:
        f.write(pipe.to_json())
    np.savez(str(tmp_path / "result.npz"),
             knn_pred=rng.randint(0, 32, (2, 30)).astype(np.int32))
    outs = {}
    for name, ckpt in (("msgpack", msgpack_path), ("bin", bin_path)):
        out = str(tmp_path / name)
        port_cli(["decode", "--result", str(tmp_path / "result.npz"),
                  "--checkpoint", ckpt, "--pipeline",
                  str(tmp_path / "pipeline.json"), "--config", config,
                  "--out", out, "--device", "cpu"])
        port_cli(["signature", "--checkpoint", ckpt, "--config", config,
                  "--out", os.path.join(out, "code.npz"), "--device", "cpu"])
        outs[name] = out
    for f in ("generated_generated.bvh", "generated_generated.npy"):
        with open(os.path.join(outs["msgpack"], f), "rb") as a, \
                open(os.path.join(outs["bin"], f), "rb") as b:
            assert a.read() == b.read(), f
    np.testing.assert_array_equal(
        np.load(os.path.join(outs["msgpack"], "code.npz"))["signature"],
        np.load(os.path.join(outs["bin"], "code.npz"))["signature"])


def test_load_fgd_extractor_reads_a_jax_file(tmp_path):
    """A JAX-initialized FGD extractor saved by the JAX package's
    save_fgd_extractor: the port's load_fgd_extractor gives the same
    stats and embeddings within 1e-5 (four strided float32 convs)."""
    from qpgesture_tpu.render import fgd_extractor as jfgd
    from qpgesture_tpu_torch.render.fgd_extractor import (fgd_encoder_fn,
                                                          load_fgd_extractor)
    cfg = jfgd.FGDExtractorConfig(channels=9, window=48, width=16, latent=8)
    jmodel = jfgd.FGDAutoencoder(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 48, 9), jnp.float32))["params"]
    rng = np.random.RandomState(8)
    mean = rng.randn(9).astype(np.float32)
    std = (rng.rand(9) + 0.5).astype(np.float32)
    path = str(tmp_path / "fgd.msgpack")
    jfgd.save_fgd_extractor(path, cfg, params, mean, std)
    model, mean2, std2 = load_fgd_extractor(path, device="cpu")
    np.testing.assert_array_equal(mean2, mean)
    np.testing.assert_array_equal(std2, std)
    windows = rng.randn(5, 48, 9).astype(np.float32)
    want = jfgd.fgd_encoder_fn(jmodel, params, mean, std)(windows)
    got = fgd_encoder_fn(model, mean2, std2)(windows)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _flax_tree():
    rng = np.random.RandomState(9)
    return {"params": {"conv": {"kernel": rng.randn(3, 4, 5).astype(
        np.float32), "bias": np.zeros(5, np.float32)},
        "ids": rng.randint(-9, 9, 7).astype(np.int32)},
        "scalar": np.float32(3.5), "step": 70000, "neg": -300, "lr": 1.25,
        "name": "x" * 40, "flag": True, "none": None,
        "empty": np.zeros((0, 4), np.float64),
        "half": rng.randn(20).astype(np.float16),
        "list": [np.ones(2, np.float32), np.arange(3)],
        "long": np.arange(70000, dtype=np.int64)}


def test_flax_msgpack_reads_and_writes_flax_bytes():
    """unpack equals flax's msgpack_restore on every leaf kind (a list is
    the map flax stores it as; a bfloat16 leaf is widened exactly); pack
    writes flax's to_bytes byte for byte."""
    tree = _flax_tree()
    tree["bf16"] = jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16)
    data = serialization.to_bytes(tree)
    got = flax_msgpack.unpack(data)
    want = serialization.msgpack_restore(data)
    assert got["list"].keys() == {"0", "1"}

    def same(a, b, path):
        if isinstance(b, dict):
            assert a.keys() == b.keys(), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, np.ndarray):
            if b.dtype == jnp.bfloat16:
                assert a.dtype == np.float32
                b = b.astype(np.float32)
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b, path
    same(got, want, "")
    del tree["bf16"]
    tree["list"] = {"0": tree["list"][0], "1": tree["list"][1]}
    assert flax_msgpack.pack(tree) == serialization.to_bytes(tree)


@pytest.mark.parametrize("cut", [1, 7, 0.5, -1])
def test_flax_msgpack_refuses_truncated_input(cut):
    data = serialization.to_bytes(_flax_tree())
    n = int(len(data) * cut) if isinstance(cut, float) else cut % len(data)
    with pytest.raises(ValueError):
        flax_msgpack.unpack(data[:n])


def test_flax_msgpack_refuses_malformed_input():
    data = serialization.to_bytes(_flax_tree())
    for bad in (b"\xc1", data + b"\x00", b"\xd4\x09\x00",
                b"\x81\x90\x01"):
        with pytest.raises(ValueError):
            flax_msgpack.unpack(bad)


@pytest.mark.parametrize("precision", ["default", "high"])
def test_train_vqvae_cli_at_precision(tmp_path, precision):
    """train-vqvae --config with conv_precision "default" / "high": two
    epochs with finite losses, a latest.pt whose model decodes at that
    precision; levels=2 raises the forward's ValueError."""
    from qpgesture_tpu_torch.train.checkpoints import restore_checkpoint
    from qpgesture_tpu_torch.train.data import WindowedDataset
    from qpgesture_tpu_torch.utils.metrics_log import ScalarHistory

    rng = np.random.RandomState(10)
    base = np.sin(np.linspace(0, 6, T))[None, :, None] * rng.randn(1, 1, 18)
    data = str(tmp_path / "data")
    WindowedDataset(poses=(base + 0.3 * rng.randn(16, T, 18)).astype(
        np.float32)).save(data)
    for levels, cfg_kw in ((1, SMALL), (2, LEVELS2)):
        vq = dict(cfg_kw, conv_precision=precision)
        cfg_path = str(tmp_path / f"cfg{levels}.yml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump({"VQVAE": {k: list(v) if isinstance(v, tuple)
                                      else v for k, v in vq.items()},
                            "batch_size": 8, "lr": 3e-3}, f)
        out = str(tmp_path / f"run{levels}")
        argv = ["train-vqvae", "--config", cfg_path, "--data", data, "--out",
                out, "--device", "cpu", "--epochs", "2"]
        if levels == 2:
            with pytest.raises(ValueError, match="level-0 decoder"):
                port_cli(argv)
            continue
        port_cli(argv)
        latest = restore_checkpoint(out, "latest")
        assert latest["step"] == 4
        losses = [v for _, _, v in ScalarHistory.read(
            os.path.join(out, "scalars.jsonl"))["loss"]]
        assert np.isfinite(losses).all()
        model = VQVAE(PortVQVAEConfig(**vq), device="cpu")
        model.load_state_dict(latest["model_dict"])
        assert model.decoders[0].out.precision == precision
        poses = model.decode(torch.zeros(1, 6, dtype=torch.long)).numpy()
        assert poses.shape == (1, T, 18) and np.isfinite(poses).all()
