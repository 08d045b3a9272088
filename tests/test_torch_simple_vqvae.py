"""SimpleVQVAE: the port against the JAX package's on the same weights
(flax tree -> state_dict with models/convert.simple_vqvae_state_dict_from_
jax): encode codes bit-equal, decode and the training forward's losses,
metrics and EMA codebook within 1e-5 (float32 convs and LSTM on both
sides, other summation orders)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qpgesture_tpu.core.config import VQVAEConfig
from qpgesture_tpu.models import bottleneck as jbn
from qpgesture_tpu.models.simple_vqvae import SimpleDecoder, SimpleEncoder
from qpgesture_tpu.models.simple_vqvae import SimpleVQVAE as JaxSimple
from qpgesture_tpu_torch.core.config import VQVAEConfig as PortVQVAEConfig
from qpgesture_tpu_torch.models import bottleneck as bn
from qpgesture_tpu_torch.models.convert import \
    simple_vqvae_state_dict_from_jax
from qpgesture_tpu_torch.models.simple_vqvae import SimpleVQVAE

CFG = dict(emb_width=16, l_bins=32, input_dim=12)
WIDTH = 32                  # the conv / LSTM width (256 in the package)
ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model and its parameters, initialized once (flax's init of
    the LSTM scan dominates the file's time)."""
    jmodel = JaxSimple(VQVAEConfig(**CFG))
    jmodel.encoder = SimpleEncoder(width=WIDTH, emb_width=CFG["emb_width"])
    jmodel.decoder = SimpleDecoder(width=WIDTH, out_dim=CFG["input_dim"])
    params = jax.jit(lambda key: jmodel.init(key)[0])(jax.random.PRNGKey(0))
    return jmodel, params


def _pair(jax_model, seed=0):
    jmodel, params = jax_model
    x = np.random.RandomState(seed).randn(3, 240, 12).astype(np.float32)
    h = jax.jit(jmodel.encoder.apply)({"params": params["encoder"]},
                                      jnp.asarray(x))
    cb = jbn.init_codebook(h.reshape(-1, CFG["emb_width"]), CFG["l_bins"],
                           jax.random.PRNGKey(seed + 1))
    # EMA statistics apart from a fresh start: some codes die this step
    g = np.random.RandomState(seed + 2)
    cb = jbn.CodebookState(k=cb.k, k_sum=cb.k * 1.1, k_elem=jnp.asarray(
        np.where(g.rand(CFG["l_bins"]) < 0.5, 0.5, 2.0), jnp.float32))
    model = SimpleVQVAE(PortVQVAEConfig(**CFG), width=WIDTH, device="cpu")
    model.load_state_dict(simple_vqvae_state_dict_from_jax(params, cb))
    return jmodel, params, cb, model, x


def test_encode_and_decode_match_jax(jax_model):
    jmodel, params, cb, model, x = _pair(jax_model)
    codes = model.encode(torch.from_numpy(x)).numpy()
    assert codes.shape == (3, 30)
    np.testing.assert_array_equal(
        codes, np.asarray(jax.jit(jmodel.encode)(params, cb, jnp.asarray(x))))
    np.testing.assert_allclose(
        model.decode(torch.from_numpy(codes)).numpy(),
        np.asarray(jax.jit(jmodel.decode)(params, cb, jnp.asarray(codes))),
        rtol=0, atol=ATOL)


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(monkeypatch, jax_model, train):
    """forward: output, loss and every metric; with ``train`` the codebook's
    EMA step (k, k_sum, k_elem) too. Dead codes restart at the rows JAX's
    key draws (bottleneck.update_codebook's fold_in(rng, 1) / (rng, 2))."""
    jmodel, params, cb, model, x = _pair(jax_model, 1)
    key = jax.random.PRNGKey(7)
    out, loss, metrics, new_cb = jax.jit(
        lambda p, c, x_, k: jmodel.forward(p, c, x_, train=train, rng=k))(
        params, cb, jnp.asarray(x), key)
    h = jax.jit(jmodel.encoder.apply)({"params": params["encoder"]},
                                      jnp.asarray(x))
    flat = h.reshape(-1, CFG["emb_width"])
    y = jbn._tile_to_k(flat, CFG["l_bins"], jax.random.fold_in(key, 1))
    perm = jax.random.permutation(jax.random.fold_in(key, 2), y.shape[0])
    rows = torch.from_numpy(np.asarray(y[perm[:CFG["l_bins"]]]))
    monkeypatch.setattr(bn, "restart_candidates", lambda *a: rows)
    got_out, got_loss, got_metrics = model(torch.from_numpy(x), train=train)
    assert abs(float(got_loss) - float(loss)) <= ATOL * float(loss)
    assert set(got_metrics) == set(metrics)
    for name, want in metrics.items():
        assert abs(float(got_metrics[name]) - float(want)) <= \
            ATOL * max(abs(float(want)), 1.0), name
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=0, atol=ATOL)
    block = model.bottleneck.level_blocks[0]
    for got, want in ((block.k, new_cb.k), (block.k_sum, new_cb.k_sum),
                      (block.k_elem, new_cb.k_elem)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


def test_gradient_matches_jax(jax_model):
    """The training forward's gradient (straight-through estimator through
    the LSTM and the convs) against jax.grad, per tensor within 1e-4 of
    its largest |g|."""
    jmodel, params, cb, model, x = _pair(jax_model, 2)

    def loss_fn(p):
        return jmodel.forward(p, cb, jnp.asarray(x), train=False)[1]
    grads = jax.jit(jax.grad(loss_fn))(params)
    want = simple_vqvae_state_dict_from_jax(grads, cb)
    model(torch.from_numpy(x), train=False)[1].backward()
    # flax's one LSTM bias is torch's bias_ih; bias_hh gets the same
    # gradient
    want["encoder.lstm.bias_hh_l0"] = want["encoder.lstm.bias_ih_l0"]
    for name, p in model.named_parameters():
        w = want[name]
        assert float((p.grad - w).abs().max()) <= \
            1e-4 * float(w.abs().max()) + 1e-9, name
