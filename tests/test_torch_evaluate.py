"""Evaluation: the metrics bit-equal to the JAX package's, the FGD
autoencoder's forward at even and odd windows against JAX's (weights carried
across both ways), its training (Adam steps in the JAX package's epoch
order) against optax from the same initial weights, the checkpoint round
trip, and train-fgd + evaluate against JAX's cli.main on the same files."""
import contextlib
import io
import json

import numpy as np
import optax
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu.render import metrics as jax_metrics
from qpgesture_tpu.render.fgd_extractor import FGDAutoencoder as JaxAE
from qpgesture_tpu.render.fgd_extractor import \
    FGDExtractorConfig as JaxFGDConfig
from qpgesture_tpu.render.fgd_extractor import \
    save_fgd_extractor as jax_save_fgd
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.models.convert import (fgd_state_dict_from_jax,
                                                fgd_state_dict_to_jax)
from qpgesture_tpu_torch.render import metrics
from qpgesture_tpu_torch.render.fgd_extractor import (FGDAutoencoder,
                                                      FGDExtractorConfig,
                                                      fgd_encoder_fn,
                                                      load_fgd_extractor,
                                                      save_fgd_extractor,
                                                      train_fgd_extractor)
from qpgesture_tpu_torch.train.train_vqvae import seeded_init

from test_torch_serve import TINY, _port_vqvae

# window 48 and width 16 for the FGD model; 9 channels
WIN, WIDTH, CH = 48, 16, 9
# the autoencoder's output and embedding: float32 on both sides, four
# strided convs, other summation orders
ATOL = 1e-5
# parameters after a few Adam steps from the same weights: Adam divides by
# sqrt(v), so an element whose gradient is within rounding of 0 may move by
# up to lr either way; the rest agree to rounding
PARAM_ATOL = 1e-5
# evaluate's fgd_feature: embeddings agree to ~1e-6; the Frechet distance
# takes a matrix square root of their covariances
FGD_FEATURE_RTOL = 1e-3


def _cfg(window=WIN, latent=8):
    return FGDExtractorConfig(channels=CH, window=window, width=WIDTH,
                              latent=latent)


def _smooth(rng, n, t=WIN, c=CH):
    tt = np.arange(t)[None, :, None] / t
    freq = rng.uniform(1, 3, size=(n, 1, c))
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1, c))
    return (np.sin(2 * np.pi * freq * tt + phase)
            + 0.05 * rng.randn(n, t, c)).astype(np.float32)


def test_metrics_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(200, 7).cumsum(0)
    b = rng.randn(180, 7).cumsum(0) * 1.3
    bins = np.linspace(0, 3, 11)
    np.testing.assert_array_equal(metrics.velocity_histogram(a, bins),
                                  jax_metrics.velocity_histogram(a, bins))
    p, q = rng.rand(4, 10), rng.rand(4, 10)
    assert metrics.hellinger(p, q) == jax_metrics.hellinger(p, q)
    assert metrics.hellinger_velocity(a, b) == \
        jax_metrics.hellinger_velocity(a, b)
    # both Frechet paths: D <= Na + Nb (covariances) and D > Na + Nb (Gram)
    for na, nb, d in ((30, 25, 6), (5, 7, 40)):
        fa, fb = rng.randn(na, d), rng.randn(nb, d) + 0.3
        assert metrics.frechet_distance(fa, fb) == \
            jax_metrics.frechet_distance(fa, fb)
    wa, wb = rng.randn(6, 12, 5), rng.randn(8, 12, 5)
    assert metrics.fgd(wa, wb) == jax_metrics.fgd(wa, wb)
    enc = lambda w: w.mean(axis=1)      # noqa: E731
    assert metrics.fgd(wa, wb, encoder=enc) == \
        jax_metrics.fgd(wa, wb, encoder=enc)


@pytest.mark.parametrize("window", [48, 45, 33])
def test_autoencoder_matches_jax_at_even_and_odd_windows(window):
    """flax's SAME padding at stride 2 is (1, 2) at even lengths and (2, 2)
    at odd ones; its ConvTranspose is torch's over the flipped kernel."""
    cfg = _cfg(window)
    torch.manual_seed(window)
    model = FGDAutoencoder(cfg, device="cpu")
    params = fgd_state_dict_to_jax(model.state_dict(), cfg)
    back = fgd_state_dict_from_jax(params, cfg)
    assert sorted(back) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    x = _smooth(np.random.RandomState(window), 3, t=window)
    recon, z = JaxAE(JaxFGDConfig(channels=CH, window=window, width=WIDTH,
                                  latent=8)).apply({"params": params},
                                                   jnp.asarray(x))
    with torch.no_grad():
        got_recon, got_z = model(torch.from_numpy(x))
    assert got_recon.shape == (3, window, CH) and got_z.shape == (3, 8)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(z), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got_recon.numpy(), np.asarray(recon), rtol=0,
                               atol=ATOL)


def test_training_matches_optax_from_the_same_weights():
    """train_fgd_extractor (two epochs of 3 batches of 8, Adam 1e-3, the
    JAX package's RandomState permutation order, stats computed and std
    clipped) against optax.adam run from the port's initial weights over
    the same batches; also the logged epochs."""
    cfg = _cfg()
    wins = _smooth(np.random.RandomState(1), 26)
    logs = []
    model, mean, std = train_fgd_extractor(wins, cfg, epochs=2,
                                           batch_size=8, seed=3,
                                           log=logs.append, device="cpu")
    assert [s.split(":")[0] for s in logs] == [
        "fgd-extractor epoch 1/2", "fgd-extractor epoch 2/2"]
    flat = wins.reshape(-1, CH)
    np.testing.assert_array_equal(mean, flat.mean(0).astype(np.float32))
    np.testing.assert_array_equal(
        std, np.clip(flat.std(0).astype(np.float32), 0.01, None))

    init = seeded_init(lambda: FGDAutoencoder(cfg, device="cpu"), 3)
    params = fgd_state_dict_to_jax(init.state_dict(), cfg)
    jmodel = JaxAE(JaxFGDConfig(channels=CH, window=WIN, width=WIDTH,
                                latent=8))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    normed = (wins - mean) / std

    @jax.jit
    def step(params, opt_state, batch):
        def loss_fn(p):
            return jnp.mean((jmodel.apply({"params": p}, batch)[0]
                             - batch) ** 2)
        grads = jax.grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state

    order_rng = np.random.RandomState(3)
    for _ in range(2):
        order = order_rng.permutation(len(wins))
        for i in range(0, len(wins) - 8 + 1, 8):
            params, opt_state = step(params, opt_state,
                                     jnp.asarray(normed[order[i:i + 8]]))
    want = fgd_state_dict_from_jax(params, cfg)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_checkpoint_round_trip_and_jax_file(tmp_path):
    cfg = _cfg()
    torch.manual_seed(4)
    model = FGDAutoencoder(cfg, device="cpu").eval()
    rng = np.random.RandomState(5)
    mean, std = rng.randn(CH).astype(np.float32), \
        (rng.rand(CH) + 0.005).astype(np.float32)
    path = str(tmp_path / "fgd.ckpt")
    save_fgd_extractor(path, model, mean, std)
    loaded, mean2, std2 = load_fgd_extractor(path, device="cpu")
    assert loaded.cfg == cfg and not loaded.training
    np.testing.assert_array_equal(mean2, mean)
    np.testing.assert_array_equal(std2, std)
    probe = _smooth(rng, 4)
    got = fgd_encoder_fn(loaded, mean2, std2)(probe)
    assert got.dtype == np.float64 and got.shape == (4, 8)
    np.testing.assert_array_equal(got, fgd_encoder_fn(model, mean, std)(
        probe))
    # the same 4-byte length + JSON header as the JAX package's file; its
    # flax msgpack payload is refused with a message saying what it is
    jax_path = str(tmp_path / "fgd.msgpack")
    jax_save_fgd(jax_path, JaxFGDConfig(channels=CH, window=WIN,
                                        width=WIDTH, latent=8),
                 fgd_state_dict_to_jax(model.state_dict(), cfg), mean, std)
    with open(jax_path, "rb") as f, open(path, "rb") as g:
        n = int.from_bytes(f.read(4), "little")
        assert g.read(4 + n)[4:] == f.read(n)
    with pytest.raises(ValueError, match="msgpack"):
        load_fgd_extractor(jax_path, device="cpu")


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    return buf.getvalue().strip().splitlines()


def test_train_fgd_and_evaluate_match_jax_cli(tmp_path):
    """train-fgd through the port's CLI; its weights carried into a JAX
    extractor file; evaluate through both CLIs on the same generated and
    ground-truth files, the same extractor weights and the same VQ-VAE
    checkpoint with the config's stats: hellinger and fgd_raw bit-equal,
    fgd_vqvae_latent equal (codes equal), fgd_feature within
    FGD_FEATURE_RTOL."""
    rng = np.random.RandomState(7)
    gt = rng.randn(40 * WIN, CH).astype(np.float32).cumsum(0) * 0.05
    gen = gt + rng.randn(*gt.shape).astype(np.float32) * 0.02
    np.save(str(tmp_path / "gt.npy"), gt)
    np.savez(str(tmp_path / "gen.npz"), poses=gen[:30 * WIN].reshape(
        30, WIN, CH))
    ckpt = str(tmp_path / "fgd.ckpt")
    lines = _run(port_cli, ["train-fgd", "--data", str(tmp_path / "gt.npy"),
                            "--out", ckpt, "--window", str(WIN),
                            "--latent", "4", "--epochs", "2",
                            "--batch-size", "16", "--device", "cpu"])
    assert lines[-1].startswith(f"wrote {ckpt}: latent=4 window={WIN} "
                                "(40 training windows)")
    model, mean, std = load_fgd_extractor(ckpt, device="cpu")
    jax_ckpt = str(tmp_path / "fgd.msgpack")
    jax_save_fgd(jax_ckpt, JaxFGDConfig(channels=CH, window=WIN,
                                        width=64, latent=4),
                 fgd_state_dict_to_jax(model.state_dict(), model.cfg),
                 mean, std)

    vq = str(tmp_path / "vqvae.bin")
    torch.save({"model_dict": _port_vqvae(input_dim=CH).state_dict()}, vq)
    config = str(tmp_path / "config.yml")
    with open(config, "w") as f:
        yaml.safe_dump({"VQVAE": dict(TINY, input_dim=CH),
                        "data_mean": (rng.randn(CH) * 0.1).tolist(),
                        "data_std": (rng.rand(CH) + 0.5).tolist()}, f)
    common = ["evaluate", "--generated", str(tmp_path / "gen.npz"),
              "--reference", str(tmp_path / "gt.npy"), "--window", str(WIN)]
    outs = {}
    for name, cli, extra in (
            ("jax", jax_cli, ["--fgd-extractor", jax_ckpt]),
            ("port", port_cli, ["--fgd-extractor", ckpt, "--device",
                                "cpu"])):
        for vq_args in ([], ["--vqvae-checkpoint", vq, "--config", config]):
            outs[name, bool(vq_args)] = json.loads(
                _run(cli, common + extra + vq_args)[-1])
        outs[name, "plain"] = json.loads(_run(
            cli, common + (["--device", "cpu"] if name == "port" else []))[-1])
    for key in (False, True, "plain"):
        want, got = outs["jax", key], outs["port", key]
        assert sorted(got) == sorted(want), key
        assert got["hellinger"] == want["hellinger"]
        assert got["fgd_raw"] == want["fgd_raw"]
        if "fgd_vqvae_latent" in want:
            assert got["fgd_vqvae_latent"] == want["fgd_vqvae_latent"]
        if "fgd_feature" in want:   # beyond the JSON's 4-decimal rounding
            assert abs(got["fgd_feature"] - want["fgd_feature"]) <= \
                FGD_FEATURE_RTOL * abs(want["fgd_feature"]) + 1e-4
    assert sorted(outs["port", "plain"]) == ["fgd_raw", "hellinger"]
    assert "fgd_vqvae_latent" in outs["port", True]
    # a window other than the extractor's is refused by both
    for cli, extra in ((jax_cli, ["--fgd-extractor", jax_ckpt]),
                       (port_cli, ["--fgd-extractor", ckpt, "--device",
                                   "cpu"])):
        with pytest.raises(SystemExit, match="extractor window"):
            _run(cli, common[:-1] + ["24"] + extra)
