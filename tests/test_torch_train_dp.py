"""Data-parallel training in a real process group: one step of each trainer
in 2 gloo ranks on the CPU (``parallel.dist.spawn``), each rank on its
contiguous half of the batch, against the JAX trainer's step on
make_mesh(2) from the same weights (carried across with the converters,
the optimizers fresh, the VQ-VAE's restart rows and the critic's
interpolation points JAX's), and for the VQ-VAE and ResyncNet against the
port's single-process step on the whole batch. The tolerances are the
single-device tests' (tests/test_torch_train_*.py): a data-parallel step
sums its gradients in another order, which Adam turns into up to lr per
element whose gradient is rounding noise. Then train-vqvae in 2 ranks:
rank 0 alone writes, and its checkpoint loads."""
import functools
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from qpgesture_tpu.core.config import End2EndConfig as JaxEnd2EndConfig
from qpgesture_tpu.core.config import PAEConfig as JaxPAEConfig
from qpgesture_tpu.core.config import ResyncConfig as JaxResyncConfig
from qpgesture_tpu.core.config import TrainConfig, VQVAEConfig
from qpgesture_tpu.models import bottleneck as jbn
from qpgesture_tpu.models.torch_convert import (convert_generator_gru,
                                                convert_vqvae)
from qpgesture_tpu.parallel.mesh import make_mesh
from qpgesture_tpu.train import train_end2end as jax_e2e
from qpgesture_tpu.train.train_pae import PAETrainer as JaxPAETrainer
from qpgesture_tpu.train.train_pae import PAETrainState
from qpgesture_tpu.train.train_resync import ResyncTrainer as JaxResync
from qpgesture_tpu.train.train_vqvae import TrainState
from qpgesture_tpu.train.train_vqvae import VQVAETrainer as JaxTrainer
from qpgesture_tpu_torch.core.config import End2EndConfig, PAEConfig
from qpgesture_tpu_torch.core.config import TrainConfig as PortTrainConfig
from qpgesture_tpu_torch.core.config import VQVAEConfig as PortVQVAEConfig
from qpgesture_tpu_torch.models import bottleneck as bn
from qpgesture_tpu_torch.models.batchnorm import sync_batchnorm
from qpgesture_tpu_torch.models.convert import (
    discriminator_state_dict_from_jax, generator_gru_state_dict_from_jax,
    pae_state_dict_from_jax,
    resync_state_dict_from_jax, vqvae_state_dict_from_jax)
from qpgesture_tpu_torch.parallel.dist import spawn
from qpgesture_tpu_torch.train.checkpoints import restore_checkpoint
from qpgesture_tpu_torch.train.data import WindowedDataset
from qpgesture_tpu_torch.train.train_vqvae import VQVAETrainer

import torch_dist_cases
import test_torch_train_end2end as e2e
import test_torch_train_pae as pae
import test_torch_train_resync as rs
import test_torch_train_vqvae as vq

N = 2
VQ_TRAIN = dict(batch_size=8, lr=1e-3)
PAE_LR = 1e-3


def _vq_setup():
    """The port trainer after init_codebook, the batch, JAX's key and the
    restart rows JAX's update draws for it from the whole batch."""
    rng = np.random.RandomState(6)
    init, x = vq._batch(rng), vq._batch(rng)
    trainer = VQVAETrainer(PortVQVAEConfig(**vq.SMALL),
                           PortTrainConfig(**VQ_TRAIN), device="cpu", seed=5)
    trainer.init_codebook(init)
    jt = JaxTrainer(VQVAEConfig(**vq.SMALL), TrainConfig(**VQ_TRAIN),
                    mesh=make_mesh(N))
    block = trainer.model.codebook_block
    params, _ = convert_vqvae(trainer.model.state_dict(),
                              VQVAEConfig(**vq.SMALL))
    state = TrainState(params=params, opt_state=jt.tx.init(params),
                       codebook=jbn.CodebookState(
                           jnp.asarray(block.k.numpy()),
                           jnp.asarray(block.k_sum.numpy()),
                           jnp.asarray(block.k_elem.numpy())),
                       step=jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(10)
    h = jt.model.encoder.apply({"params": params["encoder"]},
                               jnp.asarray(x))[-1]
    rows = torch.from_numpy(vq._jax_candidates(
        np.asarray(h).reshape(-1, vq.SMALL["emb_width"]),
        vq.SMALL["l_bins"], key))
    return trainer, jt, state, key, init, x, rows


def _e2e_cfg():
    return End2EndConfig(**e2e._cfg(lr=End2EndConfig().lr))


def _resync_setup():
    """The port trainer, JAX's trainer on make_mesh(2) and its state from
    the same weights, the batch and JAX's interpolation points."""
    trainer, jt, state = rs._pair(seed=3)
    jt = JaxResync(JaxResyncConfig(**{k: getattr(trainer.cfg, k) for k in
                                      ("lr", "gen_hop", "lambda_gp")}),
                   n_mfcc=rs.M, n_joints=rs.J, num_frames=rs.T,
                   mesh=make_mesh(N))
    x_knn, x_real = rs._data(4)
    eps = np.asarray(jax.random.uniform(jax.random.PRNGKey(0),
                                        (rs.B, 1, 1)))
    return trainer, jt, state, x_knn, x_real, eps


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of one step of each trainer, and the
    train-vqvae directory they wrote."""
    _, _, _, _, init, x, rows = _vq_setup()
    jobs = {"vqvae": ("vqvae", (PortVQVAEConfig(**vq.SMALL),
                                PortTrainConfig(**VQ_TRAIN), 5, init, x,
                                rows))}
    jobs["pae"] = ("pae", (PAEConfig(**pae.SMALL, learning_rate=PAE_LR), 2,
                           pae._windows(np.random.RandomState(3))))
    jobs["end2end"] = ("end2end", (_e2e_cfg(), 2,
                                   *e2e._batch(np.random.RandomState(3))))
    trainer, jt, state, x_knn, x_real, eps = _resync_setup()
    dims = (rs.M, rs.J, rs.T)
    cfg = trainer.cfg
    disc = trainer.disc.state_dict()
    state, _ = jt._d_step(state, jnp.asarray(x_knn), jnp.asarray(x_real),
                          jnp.asarray(eps))
    jobs["resync"] = ("resync", (cfg, dims, 3, disc, x_knn, x_real, eps,
                                 discriminator_state_dict_from_jax(
                                     {"params": state.d_params})))
    jobs["resync iteration"] = ("resync", (cfg, dims, 3, disc, x_knn, x_real,
                                           eps, None))
    tmp = tmp_path_factory.mktemp("dp_cli")
    rng = np.random.RandomState(12)
    data = str(tmp / "data")
    WindowedDataset(poses=vq._batch(rng, n=24, c=135)).save(data)
    cfg_path = str(tmp / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"VQVAE": dict(vq.SMALL, input_dim=135),
                        "batch_size": 8, "lr": 3e-3}, f)
    out = str(tmp / "run")
    argv = ["train-vqvae", "--config", cfg_path, "--data", data,
            "--epochs", "2", "--device", "cpu"]
    jobs["cli"] = ("run_cli", (argv + ["--out", out, "--dist-backend",
                                       "gloo"],))
    return spawn(torch_dist_cases.run, N, (jobs,)), (tmp, argv, out)


def _close(got, want, rtol, what):
    vq._close(got, want, rtol, what)


def _params_close(got, want, lr, skip=()):
    """Every element within 2 lr after one Adam step, 99.9 % of those
    outside ``skip`` within 1e-6."""
    close = total = 0
    for name, p in got.items():
        d = np.abs(p.numpy() - np.asarray(want[name]))
        assert d.max() <= 2 * lr + 1e-7, (name, d.max())
        if name not in skip:
            close += int((d <= 1e-6).sum())
            total += d.size
    assert close >= 0.999 * total, (close, total)


def _stats_close(got, want, atol):
    for name, b in got.items():
        if "running" in name:
            np.testing.assert_allclose(b.numpy(), np.asarray(want[name]),
                                       rtol=0, atol=atol, err_msg=name)


def test_vqvae_step_matches_jax_mesh_and_one_process(ranks):
    """Loss and metrics 1e-5 relative; parameters within 2 lr (99.9 % within
    1e-6); the EMA codebook 1e-6: every rank against JAX's step on
    make_mesh(2) and the port's single-process step on the whole batch, and
    the averaged gradients 1e-4 of each tensor's largest |g| against the
    single-process step's (which tests/test_torch_train_vqvae.py holds to
    jax.grad). A batch that does not divide by the world raises."""
    results, _ = ranks
    trainer, jt, state, key, _, x, rows = _vq_setup()
    state, loss, metrics = jt.train_step(state, x, key)
    want = vqvae_state_dict_from_jax(state.params, state.codebook,
                                     PortVQVAEConfig(**vq.SMALL))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bn, "restart_candidates", lambda *a: rows)
        one_loss, one_metrics = trainer.train_step(x)
    one = {n: p.detach() for n, p in trainer.model.named_parameters()}
    block = trainer.model.codebook_block
    assert [r["vqvae"]["rank"] for r in results] == list(range(N))
    for r in (res["vqvae"] for res in results):
        for ref_loss, ref_metrics in ((loss, metrics),
                                      (one_loss, one_metrics)):
            _close(r["loss"], ref_loss, vq.LOSS_RTOL, "loss")
            assert set(r["metrics"]) == set(ref_metrics)
            for name in ref_metrics:
                _close(r["metrics"][name], ref_metrics[name], vq.LOSS_RTOL,
                       name)
        params, grads_got, _ = r["state"]
        for name, g in grads_got.items():
            ref = trainer.model.get_parameter(name).grad.numpy()
            assert np.abs(g.numpy() - ref).max() <= \
                vq.GRAD_RTOL * np.abs(ref).max(), name
        _params_close(params, {k: want[k] for k in params}, VQ_TRAIN["lr"])
        _params_close(params, one, VQ_TRAIN["lr"])
        for got, a, b in zip(r["ema"], (block.k, block.k_sum, block.k_elem),
                             ("bottleneck.level_blocks.0.k",) + vq.EMA_KEYS):
            np.testing.assert_allclose(got.numpy(), a.numpy(), rtol=0,
                                       atol=vq.EMA_ATOL)
            np.testing.assert_allclose(got.numpy(), want[b].numpy(), rtol=0,
                                       atol=vq.EMA_ATOL)
        assert r["odd_batch"].startswith("ValueError") and \
            "does not divide among 2 ranks" in r["odd_batch"]


def test_pae_step_matches_jax_mesh(ranks):
    """Per-rank BatchNorm statistics as JAX's shards keep them: the loss
    1e-5, parameters within 2 lr (99.9 % of those not feeding a BatchNorm
    within 1e-6), the averaged running statistics 1e-6; the eval loss is
    the same on both ranks (JAX's is not the reference there: a bias that
    feeds a BatchNorm moves by Adam's noise, which the eval's running
    statistics do not absorb)."""
    results, _ = ranks
    cfg = PAEConfig(**pae.SMALL, learning_rate=PAE_LR)
    from qpgesture_tpu_torch.train.train_pae import PAETrainer
    variables = pae._carry(PAETrainer(cfg, device="cpu", seed=2))
    jt = JaxPAETrainer(JaxPAEConfig(**pae.SMALL, learning_rate=PAE_LR),
                       mesh=make_mesh(N), steps_per_epoch=1)
    state = PAETrainState(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=jt.tx.init(variables["params"]),
                          step=jnp.zeros((), jnp.int32))
    x = pae._windows(np.random.RandomState(3))
    state, loss = jt.train_step(state, x)
    want = pae_state_dict_from_jax({"params": state.params,
                                    "batch_stats": state.batch_stats}, cfg)
    assert len({res["pae"]["eval"] for res in results}) == 1
    for r in (res["pae"] for res in results):
        _close(r["loss"], loss, pae.LOSS_RTOL, "loss")
        params, _, bufs = r["state"]
        _params_close(params, want, PAE_LR, skip=pae.BN_FED)
        _stats_close(bufs, want, pae.STATS_ATOL)
        assert np.isfinite(r["eval"])


def test_end2end_step_matches_jax_mesh(ranks):
    """GeneratorGRU at dropout 0, per-rank BatchNorm statistics: the loss
    1e-5, parameters within 2 lr, Adam's moments 1e-4 of each tensor's
    largest, the averaged running statistics 1e-6."""
    results, _ = ranks
    cfg = _e2e_cfg()
    from qpgesture_tpu_torch.train.train_end2end import End2EndTrainer
    variables = convert_generator_gru(
        End2EndTrainer(cfg, device="cpu", seed=2).model.state_dict(),
        e2e.HIDDEN)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_e2e, "GeneratorGRU",
                   functools.partial(e2e.JaxGRU, dropout=0.0))
        jt = jax_e2e.End2EndTrainer(JaxEnd2EndConfig(**e2e._cfg(lr=cfg.lr)),
                                    mesh=make_mesh(N))
        state = jax_e2e.End2EndTrainState(
            params=variables["params"], batch_stats=variables["batch_stats"],
            opt_state=jt.tx.init(variables["params"]),
            step=jnp.zeros((), jnp.int32))
        wav, codes = e2e._batch(np.random.RandomState(3))
        state, loss = jt.train_step(state, wav, codes, jax.random.PRNGKey(0))
    want = generator_gru_state_dict_from_jax(
        {"params": state.params, "batch_stats": state.batch_stats})
    adam = state.opt_state[0]
    moments = [generator_gru_state_dict_from_jax(
        {"params": tree, "batch_stats": state.batch_stats})
        for tree in (adam.mu, adam.nu)]
    for r in (res["end2end"] for res in results):
        _close(r["loss"], loss, e2e.LOSS_RTOL, "loss")
        params, _, bufs = r["state"]
        for name, p in params.items():
            d = np.abs(p.numpy() - want[name].numpy())
            assert d.max() <= 2 * cfg.lr, (name, d.max())
            if name in e2e.BN_FED:
                continue
            for got, m in zip(r["moments"][name], moments):
                w = m[name].numpy()
                assert np.abs(got.numpy() - w).max() <= \
                    e2e.GRAD_RTOL * np.abs(w).max(), name
        _stats_close(bufs, want, e2e.STATS_ATOL)


def test_resync_steps_match_jax_mesh_and_one_process(ranks):
    """One critic step and one generator step: the losses 1e-5, each
    gradient 1e-4 of its norm (the BatchNorm- and InstanceNorm-fed biases,
    whose gradients are rounding noise, against the largest), parameters
    within 2 lr, the generator's synchronised BatchNorm statistics 1e-6:
    every rank against JAX's _d_step / _g_step on make_mesh(2) and, through
    train_iteration, against the port's single-process iteration with the
    generator's BatchNorms in the same (flax's) formula."""
    results, _ = ranks
    trainer, jt, state, x_knn, x_real, eps = _resync_setup()
    lr = trainer.cfg.lr
    state, jd = jt._d_step(state, jnp.asarray(x_knn), jnp.asarray(x_real),
                           jnp.asarray(eps))
    disc_after_d = discriminator_state_dict_from_jax(
        {"params": state.d_params})
    gen_after_d = resync_state_dict_from_jax({"params": state.g_params,
                                              "batch_stats": state.g_stats})
    state, jg = jt._g_step(state, jnp.asarray(x_knn), jnp.asarray(x_real))
    gen_after_g = resync_state_dict_from_jax({"params": state.g_params,
                                              "batch_stats": state.g_stats})
    sync_batchnorm(trainer.gen)     # flax's statistics, as the ranks'
    logs = trainer.train_iteration(x_knn, x_real, 0, torch.from_numpy(eps))
    one_gen = dict(trainer.gen.named_parameters())
    one_disc = dict(trainer.disc.named_parameters())
    zero_g, zero_d = rs._conv_biases(trainer.gen), rs._conv_biases(
        trainer.disc)
    for res in results:
        r = res["resync"]
        for k, want in (("d_loss", jd), ("g_loss", jg)):
            _close(r["loss"][k], want, rs.LOSS_RTOL, k)
        _params_close(r["disc"][0], disc_after_d, lr, skip=zero_d)
        _stats_close(r["gen_after_d"], gen_after_d, rs.STATS_ATOL)
        _params_close(r["gen"][0], gen_after_g, lr, skip=zero_g)
        _stats_close(r["gen"][2], gen_after_g, rs.STATS_ATOL)
        it = res["resync iteration"]
        for k in ("d_loss", "g_loss"):
            _close(it["loss"][k], logs[k], rs.LOSS_RTOL, k)
        for part, ref, zero in (("gen", one_gen, zero_g),
                                ("disc", one_disc, zero_d)):
            params, grads, bufs = it[part]
            top = max(float(p.grad.abs().max()) for p in ref.values())
            for name, g in grads.items():
                w = ref[name].grad.numpy()
                if name in zero:
                    assert np.abs(g.numpy()).max() <= rs.GRAD_RTOL * top
                    continue
                assert rs._grad_err(w, g.numpy()) <= rs.GRAD_RTOL, name
            _params_close(params, {n: p.detach() for n, p in ref.items()},
                          lr, skip=zero)
        _stats_close(it["gen"][2], dict(trainer.gen.named_buffers()),
                     rs.STATS_ATOL)


def test_train_vqvae_cli_in_two_ranks(ranks):
    """train-vqvae in 2 gloo ranks: rank 0 alone writes the directory (one
    set of checkpoints and one history), its latest.pt counts the updates
    of 2 epochs of 3 batches and loads into the model, and its weights are
    those of the single-process CLI on the same data within 2 lr per
    step."""
    _, (tmp, argv, out) = ranks
    assert sorted(os.listdir(out)) == ["latest.pt", "scalars.jsonl"]
    latest = restore_checkpoint(out, "latest")
    assert (latest["step"], latest["epoch"]) == (6, 2)
    from qpgesture_tpu_torch.cli import main
    one = str(tmp / "one")
    main(argv + ["--out", one])
    single = restore_checkpoint(one, "latest")["model_dict"]
    from qpgesture_tpu_torch.models.vqvae import VQVAE
    model = VQVAE(PortVQVAEConfig(**dict(vq.SMALL, input_dim=135)),
                  device="cpu")
    model.load_state_dict(latest["model_dict"])
    for name, p in model.named_parameters():
        assert np.abs(p.detach().numpy() - single[name].numpy()).max() <= \
            2 * 3e-3 * 6, name
