"""VQ-VAE: a random port model, converted to flax with the JAX package's own
converter, encodes and decodes like the JAX model; the port's inverse
converter round-trips the state_dict exactly; a reference-layout checkpoint
loads into the port."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qpgesture_tpu.core.config import VQVAEConfig
from qpgesture_tpu.models.torch_convert import convert_vqvae
from qpgesture_tpu.models.vqvae import VQVAE as JaxVQVAE
from qpgesture_tpu_torch.core.config import VQVAEConfig as PortVQVAEConfig
from qpgesture_tpu_torch.models.convert import (load_vqvae_checkpoint,
                                                vqvae_state_dict_from_jax)
from qpgesture_tpu_torch.models.vqvae import VQVAE

SMALL = dict(width=32, emb_width=32, l_bins=64, depth=3)


def _port_model(seed, **kw):
    torch.manual_seed(seed)
    model = VQVAE(PortVQVAEConfig(**kw), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    model.codebook.copy_(torch.randn(model.codebook.shape, generator=g))
    return model


def test_small_encode_decode_match_jax():
    """Tolerance 1e-4: float32 convolutions summed in different orders by
    XLA and PyTorch, through 20 layers of O(1) activations."""
    model = _port_model(0, **SMALL)
    cfg = VQVAEConfig(**SMALL)
    params, cb = convert_vqvae(model.state_dict(), cfg)
    jmodel = JaxVQVAE(cfg)
    rng = np.random.RandomState(0)

    codes = rng.randint(0, cfg.l_bins, size=(2, 7)).astype(np.int64)
    want = np.asarray(jmodel.decode(params, cb, jnp.asarray(codes)))
    got = model.decode(torch.from_numpy(codes)).numpy()
    assert got.shape == (2, 7 * cfg.hop_length, cfg.input_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    x = rng.randn(2, 48, cfg.input_dim).astype(np.float32)
    h_want = np.asarray(jmodel.encoder.apply({"params": params["encoder"]},
                                             jnp.asarray(x))[-1])
    h_got = model.encoders[0](torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(h_got, h_want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        model.encode(torch.from_numpy(x)).numpy(),
        np.asarray(jmodel.encode(params, cb, jnp.asarray(x))))


def test_default_width_decode_matches_jax():
    """The default config (width 512, emb 512, 512 bins, depth 3) on a
    short code string."""
    model = _port_model(1)
    cfg = VQVAEConfig()
    params, cb = convert_vqvae(model.state_dict(), cfg)
    codes = np.random.RandomState(1).randint(0, 512, size=(1, 4))
    want = np.asarray(JaxVQVAE(cfg).decode(params, cb, jnp.asarray(codes)))
    got = model.decode(torch.from_numpy(codes)).numpy()
    assert got.shape == (1, 32, 135)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [SMALL, dict(width=16, emb_width=8, l_bins=32,
                                            depth=2, downs_t=(2,),
                                            vqvae_reverse_decoder_dilation=
                                            False)])
def test_state_dict_round_trip_is_exact(kw):
    model = _port_model(2, **kw)
    sd = model.state_dict()
    params, cb = convert_vqvae(sd, VQVAEConfig(**kw))
    back = vqvae_state_dict_from_jax(params, cb, PortVQVAEConfig(**kw))
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    model.load_state_dict(back)


def test_reference_checkpoint_loads(tmp_path):
    """A reference-style checkpoint: {'model_dict': ...} with the
    DataParallel 'module.' prefix and EMA buffers the port does not hold."""
    src = _port_model(3, **SMALL)
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["module.bottleneck.level_blocks.0.k_sum"] = torch.zeros(64, 32)
    path = str(tmp_path / "codebook_checkpoint_best.bin")
    torch.save({"model_dict": sd, "epoch": 3}, path)
    model = load_vqvae_checkpoint(path, PortVQVAEConfig(**SMALL),
                                  device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    del sd["module.decoders.0.out.bias"]
    torch.save({"model_dict": sd}, path)
    with pytest.raises(KeyError):
        load_vqvae_checkpoint(path, PortVQVAEConfig(**SMALL), device="cpu")
