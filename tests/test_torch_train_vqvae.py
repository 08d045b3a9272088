"""VQ-VAE training: the port's EMA codebook update, training forward,
gradients, learning-rate schedule and trainer steps against the JAX
package's on the same weights and batches (carried across with the JAX
package's converter, both optimizers fresh); checkpoint_res; the fit loop's
best / latest / resume semantics; the train-vqvae CLI with decode and
signature from its output directory."""
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from qpgesture_tpu.core.config import TrainConfig, VQVAEConfig
from qpgesture_tpu.models import bottleneck as jbn
from qpgesture_tpu.models.torch_convert import convert_vqvae
from qpgesture_tpu.models.vqvae import VQVAE as JaxVQVAE
from qpgesture_tpu.models.vqvae import eval_pose_error as jax_pose_error
from qpgesture_tpu.parallel.mesh import make_mesh
from qpgesture_tpu.train.train_vqvae import TrainState, make_lr_schedule
from qpgesture_tpu.train.train_vqvae import VQVAETrainer as JaxTrainer
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.core.config import TrainConfig as PortTrainConfig
from qpgesture_tpu_torch.core.config import VQVAEConfig as PortVQVAEConfig
from qpgesture_tpu_torch.models import bottleneck as bn
from qpgesture_tpu_torch.models.convert import (EMA_KEYS,
                                                load_vqvae_checkpoint,
                                                vqvae_state_dict_from_jax)
from qpgesture_tpu_torch.models.vqvae import VQVAE, eval_pose_error
from qpgesture_tpu_torch.train.checkpoints import restore_checkpoint
from qpgesture_tpu_torch.train.data import WindowedDataset
from qpgesture_tpu_torch.train.train_vqvae import VQVAETrainer, lr_at
from qpgesture_tpu_torch.utils.metrics_log import ScalarHistory

SMALL = dict(width=16, emb_width=16, l_bins=16, depth=1, input_dim=18,
             sample_length=6)
T = 48                      # frames per window: 6 latent steps at x8
# losses and metrics: float32 on both sides, other summation orders
LOSS_RTOL = 1e-5
# gradients, relative to each tensor's largest |g|
GRAD_RTOL = 1e-4
# EMA codebook (k, k_sum, k_elem) of unit-scale latents
EMA_ATOL = 1e-6
METRICS = {"fit", "pn", "entropy", "used_curr", "usage", "dk", "recons_loss",
           "l1_loss", "commit_loss", "regularization", "velocity_loss",
           "acceleration_loss"}


def _batch(rng, n=8, t=T, c=SMALL["input_dim"]):
    base = np.sin(np.linspace(0, 6, t))[None, :, None] * rng.randn(1, 1, c)
    return (base + 0.3 * rng.randn(n, t, c)).astype(np.float32)


def _port_model(seed, **kw):
    torch.manual_seed(seed)
    return VQVAE(PortVQVAEConfig(**{**SMALL, **kw}), device="cpu")


def _jax_candidates(flat, k_bins, rng):
    """The JAX update's restart rows for ``rng`` (update_codebook's draws on
    one device)."""
    y = jbn._tile_to_k(jnp.asarray(flat), k_bins, jax.random.fold_in(rng, 1))
    perm = jax.random.permutation(jax.random.fold_in(rng, 2), y.shape[0])
    return np.asarray(y[perm[:k_bins]])


def _close(got, want, rtol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-12), \
        f"{what}: {got} vs {want}"


@pytest.mark.parametrize("m", [48, 10])
def test_update_codebook_matches_jax(m):
    """Dead codes restart from passed-in rows; m=10 < K tiles the rows."""
    rng = np.random.RandomState(m)
    K, D = 16, 8
    k = rng.randn(K, D).astype(np.float32)
    k_sum = (k * 1.3).astype(np.float32)
    k_elem = np.where(rng.rand(K) < 0.5, 0.2, 1.7).astype(np.float32)
    x = rng.randn(m, D).astype(np.float32)
    state = jbn.CodebookState(jnp.asarray(k), jnp.asarray(k_sum),
                              jnp.asarray(k_elem))
    codes, _ = jbn.quantise(state, jnp.asarray(x))
    key = jax.random.PRNGKey(m)
    want, wmet = jbn.update_codebook(state, jnp.asarray(x), codes, 0.99, key)
    (pk, pks, pke), pmet = bn.update_codebook(
        (torch.from_numpy(k), torch.from_numpy(k_sum),
         torch.from_numpy(k_elem)), torch.from_numpy(x),
        torch.from_numpy(np.asarray(codes)), 0.99,
        k_rand=torch.from_numpy(_jax_candidates(x, K, key)))
    dead = np.asarray(want.k_elem) < 1.0
    assert dead.any() and not dead.all()
    for got, w in ((pk, want.k), (pks, want.k_sum), (pke, want.k_elem)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=EMA_ATOL)
    assert set(pmet) == set(wmet)
    for name in wmet:
        _close(pmet[name], wmet[name], LOSS_RTOL, name)


def _carry(model, k_elem=None):
    """The port model's weights and codebook as JAX params + CodebookState;
    the codebook's EMA statistics set apart from k."""
    block = model.codebook_block
    g = torch.Generator().manual_seed(3)
    k = torch.randn(block.k.shape, generator=g)
    block.set_state(k, 1.1 * k, torch.where(torch.rand(k.shape[0],
                                                       generator=g) < 0.5,
                                            0.5, 2.0)
                    if k_elem is None else k_elem)
    params, cb = convert_vqvae(model.state_dict(), VQVAEConfig(**SMALL))
    cb = jbn.CodebookState(jnp.asarray(block.k.numpy()),
                           jnp.asarray(block.k_sum.numpy()),
                           jnp.asarray(block.k_elem.numpy()))
    return params, cb


@pytest.mark.parametrize("train", [True, False])
def test_forward_loss_and_metrics_match_jax(monkeypatch, train):
    model = _port_model(0)
    params, cb = _carry(model)
    jmodel = JaxVQVAE(VQVAEConfig(**SMALL))
    x = _batch(np.random.RandomState(1))
    key = jax.random.PRNGKey(7)
    x_out, loss, metrics, new_cb = jmodel.forward(
        params, cb, jnp.asarray(x), train=train, rng=key)
    h = jmodel.encoder.apply({"params": params["encoder"]}, jnp.asarray(x))
    rows = torch.from_numpy(_jax_candidates(
        np.asarray(h[-1]).reshape(-1, SMALL["emb_width"]),
        SMALL["l_bins"], key))
    monkeypatch.setattr(bn, "restart_candidates", lambda *a: rows)
    got_out, got_loss, got_metrics = model(torch.from_numpy(x), train=train)
    _close(got_loss, loss, LOSS_RTOL, "loss")
    assert set(got_metrics) == set(metrics) == (
        METRICS if train else METRICS - {"entropy", "used_curr", "usage",
                                         "dk"})
    for name in metrics:
        _close(got_metrics[name], metrics[name], LOSS_RTOL, name)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(x_out),
                               rtol=0, atol=1e-5)
    block = model.codebook_block
    for got, want in ((block.k, new_cb.k), (block.k_sum, new_cb.k_sum),
                      (block.k_elem, new_cb.k_elem)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=EMA_ATOL)
    _close(eval_pose_error(torch.from_numpy(x), got_out.detach()),
           jax_pose_error(jnp.asarray(x), x_out), LOSS_RTOL,
           "eval_pose_error")


def _grads_by_name(grads, cb):
    """A JAX gradient tree under the port's parameter names (the converter
    is linear in the kernels)."""
    return vqvae_state_dict_from_jax(grads, cb, PortVQVAEConfig(**SMALL))


def test_gradients_match_jax_grad():
    model = _port_model(2)
    params, cb = _carry(model)
    jmodel = JaxVQVAE(VQVAEConfig(**SMALL))
    x = _batch(np.random.RandomState(2))

    def loss_fn(p):
        return jmodel.forward(p, cb, jnp.asarray(x), train=False)[1]

    want = _grads_by_name(jax.grad(loss_fn)(params), cb)
    _, loss, _ = model(torch.from_numpy(x), train=False)
    loss.backward()
    for name, p in model.named_parameters():
        w = want[name].numpy()
        scale = np.abs(w).max()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= GRAD_RTOL * scale, f"{name}: {err} of {scale}"


def test_checkpoint_res_recomputes_with_equal_gradients():
    """checkpoint_res recomputes each residual block in the backward pass
    (its convolutions run twice) and gives the gradients of the plain model:
    the same float32 operations on the same inputs, so equal to 1e-6 of each
    tensor's largest |g|."""
    x = torch.from_numpy(_batch(np.random.RandomState(3)))
    grads, calls = [], []
    for ckpt in (False, True):
        model = _port_model(4, checkpoint_res=ckpt)
        block = model.encoders[0].level_blocks[0].model[0][1].model[0]
        n = [0]
        block.model[1].register_forward_hook(
            lambda *a, n=n: n.__setitem__(0, n[0] + 1))
        _, loss, _ = model(x, train=False)
        loss.backward()
        calls.append(n[0])
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    assert calls == [1, 2]
    for k, g in grads[0].items():
        scale = float(g.abs().max())
        assert float((grads[1][k] - g).abs().max()) <= 1e-6 * max(scale,
                                                                  1e-30), k


def test_multistep_lr_matches_optax():
    """lr_at against optax's piecewise_constant_schedule (the JAX package's
    make_lr_schedule) at and around every boundary; optax evaluated in
    float64, 1e-7 relative."""
    for spe in (1, 7):
        cfg = TrainConfig(lr=3e-5, milestones=(2, 5), gamma=0.1)
        pcfg = PortTrainConfig(lr=3e-5, milestones=(2, 5), gamma=0.1)
        with jax.enable_x64(True):
            sched = make_lr_schedule(cfg, spe)
            steps = sorted({s + d for s in (0, 2 * spe, 5 * spe, 9 * spe)
                            for d in (-1, 0, 1) if s + d >= 0})
            for s in steps:
                _close(lr_at(pcfg, spe, s), sched(s), 1e-7, f"step {s}")


def _port_and_jax_trainers(lr=1e-3):
    """A port trainer on the CPU and the JAX trainer on a one-device mesh,
    from the port's weights, with milestones at updates 1 and 2."""
    tcfg = dict(batch_size=8, lr=lr, milestones=(1, 2), gamma=0.5)
    trainer = VQVAETrainer(PortVQVAEConfig(**SMALL), PortTrainConfig(**tcfg),
                           device="cpu", seed=5)
    jt = JaxTrainer(VQVAEConfig(**SMALL), TrainConfig(**tcfg),
                    mesh=make_mesh(1))
    return trainer, jt


def test_three_trainer_steps_match_jax(monkeypatch):
    """Losses and metrics 1e-5 relative; gradients 1e-4 of each tensor's
    largest |g|; the EMA codebook 1e-6. Parameters: Adam's update
    lr * m / (|v|^0.5 + eps) moves an element whose gradient sits within a
    few ulp of zero by up to lr either way, so every element is held to
    2 * lr per step and 99.9 % of them to 1e-6."""
    lr = 1e-3
    trainer, jt = _port_and_jax_trainers(lr)
    rng = np.random.RandomState(6)
    batches = [_batch(rng) for _ in range(3)]
    trainer.init_codebook(batches[0])
    block = trainer.model.codebook_block
    params, _ = convert_vqvae(trainer.model.state_dict(), VQVAEConfig(**SMALL))
    state = TrainState(params=params, opt_state=jt.tx.init(params),
                       codebook=jbn.CodebookState(
                           jnp.asarray(block.k.numpy()),
                           jnp.asarray(block.k_sum.numpy()),
                           jnp.asarray(block.k_elem.numpy())),
                       step=jnp.zeros((), jnp.int32))
    for i, x in enumerate(batches):
        key = jax.random.PRNGKey(10 + i)
        h = jt.model.encoder.apply({"params": state.params["encoder"]},
                                   jnp.asarray(x))[-1]
        rows = torch.from_numpy(_jax_candidates(
            np.asarray(h).reshape(-1, SMALL["emb_width"]), SMALL["l_bins"],
            key))
        monkeypatch.setattr(bn, "restart_candidates", lambda *a: rows)

        grads = jax.grad(lambda p: jt.model.forward(
            p, state.codebook, jnp.asarray(x), train=True, rng=key)[1])(
                state.params)
        want_g = _grads_by_name(grads, state.codebook)
        state, loss, metrics = jt.train_step(state, x, key)
        got_loss, got_metrics = trainer.train_step(x)
        _close(got_loss, loss, LOSS_RTOL, f"step {i} loss")
        for name in metrics:
            _close(got_metrics[name], metrics[name], LOSS_RTOL,
                   f"step {i} {name}")
        want = vqvae_state_dict_from_jax(state.params, state.codebook,
                                         PortVQVAEConfig(**SMALL))
        for name, p in trainer.model.named_parameters():
            g = want_g[name].numpy()
            assert np.abs(p.grad.numpy() - g).max() <= \
                GRAD_RTOL * np.abs(g).max(), f"step {i} grad {name}"
            d = np.abs(p.detach().numpy() - want[name].numpy())
            assert d.max() <= 2 * lr * (i + 1), f"step {i} {name}"
            assert np.mean(d <= 1e-6) >= 0.999, f"step {i} {name}"
        for name, key_ in zip(("k", "k_sum", "k_elem"),
                              ("bottleneck.level_blocks.0.k",) + EMA_KEYS):
            np.testing.assert_allclose(getattr(block, name).numpy(),
                                       want[key_].numpy(), rtol=0,
                                       atol=EMA_ATOL)
    assert trainer.step == int(state.step) == 3


def test_vqvae_state_dict_carries_the_ema_statistics():
    model = _port_model(8)
    params, cb = _carry(model)
    sd = vqvae_state_dict_from_jax(params, cb, PortVQVAEConfig(**SMALL))
    assert set(sd) == set(model.state_dict()) | set(EMA_KEYS)
    fresh = _port_model(9)
    fresh.load_state_dict(sd)
    block = fresh.codebook_block
    for name, key in zip(("k_sum", "k_elem"), EMA_KEYS):
        assert torch.equal(getattr(block, name), sd[key])
    # a reference-layout state_dict (k only) loads and leaves them alone
    fresh.load_state_dict(model.state_dict())
    assert torch.equal(block.k_sum, sd[EMA_KEYS[0]])


def _fit_setup(tmp_path, seed=11):
    rng = np.random.RandomState(seed)
    train = [_batch(rng) for _ in range(4)]
    val = [_batch(rng) for _ in range(2)]
    trainer = VQVAETrainer(
        PortVQVAEConfig(**SMALL),
        PortTrainConfig(batch_size=8, lr=3e-3, save_per_epochs=2),
        steps_per_epoch=4, device="cpu", seed=seed)
    trainer.init_codebook(train[0])
    return trainer, train, val


def test_fit_best_latest_and_resume(tmp_path):
    """Validation at each epoch's start and after the last; best.pt on a
    better val_err, latest.pt every epoch, {epoch:03d}.pt every
    save_per_epochs; the loss falls; a resumed run restores the update
    count, numbers its epoch on and keeps the prior best."""
    out = str(tmp_path / "run")
    trainer, train, val = _fit_setup(tmp_path)
    best = trainer.fit(train, val, epochs=3, log_every=1,
                       checkpoint_dir=out)
    assert sorted(os.listdir(out)) == ["002.pt", "best.pt", "latest.pt",
                                       "scalars.jsonl"]
    hist = ScalarHistory.read(os.path.join(out, "scalars.jsonl"))
    assert [e for e, _, _ in hist["val_err"]] == [1, 2, 3, 4]
    assert best == min(((v, e) for e, _, v in hist["val_err"]))
    losses = [v for _, _, v in hist["loss"]]
    assert len(losses) == 12 and np.mean(losses[-4:]) < np.mean(losses[:4])
    assert set(hist) >= METRICS | {"loss", "best_val_err"}
    latest = restore_checkpoint(out, "latest")
    assert latest["step"] == 12 and latest["epoch"] == 3
    assert restore_checkpoint(out, "best")["epoch"] == best[1]

    resumed, _, _ = _fit_setup(tmp_path, seed=99)
    resumed.load_state_dict(latest)
    assert resumed.step == 12
    for a, b in zip(resumed.model.state_dict().values(),
                    trainer.model.state_dict().values()):
        assert torch.equal(a, b)
    start = resumed.step // len(train) + 1
    best2 = resumed.fit(train, val, epochs=4, checkpoint_dir=out,
                        start_epoch=start, initial_best=best)
    assert start == 4 and resumed.step == 16
    hist = ScalarHistory.read(os.path.join(out, "scalars.jsonl"))
    assert [e for e, _, _ in hist["val_err"]] == [1, 2, 3, 4, 4, 5]
    assert best2[0] <= best[0]
    assert restore_checkpoint(out, "latest")["epoch"] == 4
    assert "004.pt" in os.listdir(out)


def test_fit_stops_on_a_non_finite_loss(tmp_path):
    trainer, train, _ = _fit_setup(tmp_path)
    bad = [train[0], np.full_like(train[1], np.nan)]
    with pytest.raises(FloatingPointError, match="epoch 1 step 1"):
        trainer.fit(bad, epochs=1, log_every=1)


def test_train_vqvae_cli_resume_decode_and_signature(tmp_path, capsys):
    """train-vqvae for 2 epochs with validation, --resume to 3; decode and
    signature from the output directory equal the library calls on the
    model its best.pt holds."""
    from test_build_db_cli import make_beat_like_bvh
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    from qpgesture_tpu_torch.motion.pipeline import MotionPipeline
    from qpgesture_tpu_torch.models.vqvae import codebook_signature

    rng = np.random.RandomState(12)
    data, val = str(tmp_path / "data"), str(tmp_path / "val")
    cfg = {"VQVAE": dict(SMALL, input_dim=135), "batch_size": 8,
           "lr": 3e-3, "save_per_epochs": 2, "val_data_path": val}
    # 135 channels: the decode CLI writes BVH through a 15-joint pipeline
    WindowedDataset(poses=_batch(rng, n=24, c=135)).save(data)
    WindowedDataset(poses=_batch(rng, n=8, c=135)).save(val)
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = str(tmp_path / "run")
    base = ["train-vqvae", "--config", cfg_path, "--data", data, "--out",
            out, "--device", "cpu"]
    port_cli(base + ["--epochs", "2"])
    assert restore_checkpoint(out, "latest")["step"] == 6
    port_cli(base + ["--epochs", "3", "--resume"])
    assert "resumed from" in capsys.readouterr().out
    latest = restore_checkpoint(out, "latest")
    assert (latest["step"], latest["epoch"]) == (9, 3)
    hist = ScalarHistory.read(os.path.join(out, "scalars.jsonl"))
    assert [e for e, _, _ in hist["val_err"]] == [1, 2, 3, 3, 4]

    vcfg = PortVQVAEConfig(**dict(SMALL, input_dim=135))
    model = load_vqvae_checkpoint(out, vcfg, device="cpu")
    best = restore_checkpoint(out, "best")["model_dict"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, best[k]), k
    assert torch.equal(model.codebook_block.k_elem, best[EMA_KEYS[1]])

    pipe = MotionPipeline(fps=60).fit(parse_bvh(make_beat_like_bvh(rng, 300)))
    pipe_path = str(tmp_path / "pipeline.json")
    with open(pipe_path, "w") as f:
        f.write(pipe.to_json())
    result = str(tmp_path / "result.npz")
    np.savez(result, knn_pred=rng.randint(0, 16, (2, 30)).astype(np.int32))
    port_cli(["decode", "--result", result, "--checkpoint", out,
              "--pipeline", pipe_path, "--config", cfg_path, "--out",
              str(tmp_path / "bvh"), "--device", "cpu"])
    assert parse_bvh(str(tmp_path / "bvh" / "generated_generated.bvh")
                     ).values.shape[0] == 2 * 240
    sig = str(tmp_path / "code.npz")
    port_cli(["signature", "--checkpoint", out, "--config", cfg_path,
              "--out", sig, "--device", "cpu"])
    np.testing.assert_array_equal(np.load(sig)["signature"],
                                  codebook_signature(model)[2])

    orbax = tmp_path / "orbax"
    (orbax / "best").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match=r"best\.pt.*\['best'\]"):
        port_cli(["signature", "--checkpoint", str(orbax), "--config",
                  cfg_path, "--out", sig, "--device", "cpu"])
