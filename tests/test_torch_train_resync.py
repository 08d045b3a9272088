"""ResyncNet WGAN-GP training: the critic's forward, the gradient penalty and
its gradient against the JAX package's (weights carried across with the
converters, both ways), one critic step and one generator step of
ResyncTrainer against JAX's ``_d_step`` / ``_g_step`` from the same weights
with fresh optimizers and JAX's interpolation points, and the train-resync
CLI whose directory generate --resync, resync-apply and
load_resync_checkpoint read."""
import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu.core.config import ResyncConfig as JaxResyncConfig
from qpgesture_tpu.models.resync import Discriminator as JaxDiscriminator
from qpgesture_tpu.models.resync import ResyncNet as JaxResyncNet
from qpgesture_tpu.models.resync import \
    gradient_penalty as jax_gradient_penalty
from qpgesture_tpu.models.torch_convert import convert_resync
from qpgesture_tpu.train.train_resync import ResyncTrainer as JaxTrainer
from qpgesture_tpu.train.train_resync import ResyncTrainState
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.core.config import ResyncConfig
from qpgesture_tpu_torch.models.convert import (
    discriminator_state_dict_from_jax, discriminator_state_dict_to_jax,
    load_resync_checkpoint, resync_state_dict_from_jax)
from qpgesture_tpu_torch.models.resync import (Discriminator,
                                               gradient_penalty)
from qpgesture_tpu_torch.train.checkpoints import restore_checkpoint
from qpgesture_tpu_torch.train.train_resync import ResyncTrainer

from test_torch_end2end import read_generated, write_end2end_inputs

# the small shapes of tests/test_trainers_aux.py: T = 32, batch 4, 5 MFCC
# channels and 9 joints
T, B, M, J = 32, 4, 5, 9
# critic scores and losses: float32 on both sides, other summation orders
# through six convs of 512-128 channels
ATOL = 1e-5
LOSS_RTOL = 1e-5
# gradients per tensor, ||g_port - g_jax|| / ||g_jax||: the penalty is a
# double backward through six InstanceNorms
GRAD_RTOL = 1e-4
# BatchNorm running statistics after a step
STATS_ATOL = 1e-6


def _data(seed, n=B):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, T, M + J).astype(np.float32),
            rng.randn(n, T, M + J).astype(np.float32))


def _disc(seed, channels=M + J, frames=T):
    torch.manual_seed(seed)
    disc = Discriminator(channels, frames, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():       # InstanceNorm affine terms away from (1, 0)
        for name, p in disc.named_parameters():
            if name.endswith((".1.weight", ".4.weight")):
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=g))
            elif name.endswith((".1.bias", ".4.bias")):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return disc


def _nct(x):
    return torch.from_numpy(x.transpose(0, 2, 1).copy())


def _conv_biases(module):
    """Conv biases that feed a normalization over time (BatchNorm in the
    generator, InstanceNorm in the critic): their gradient is 0, what either
    side computes is rounding noise."""
    return {n for n, _ in module.named_parameters()
            if n.endswith((".0.bias", ".3.bias"))}


def _grad_err(want, got):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("frames", [32, 36])
def test_critic_matches_jax_and_converts_both_ways(frames):
    """At T=36 the pooled map (4 frames) is not T/8 exactly: both flatten
    what the third pooling leaves, and the Linear holds 128 * (T // 8)."""
    disc = _disc(0, frames=frames)
    variables = discriminator_state_dict_to_jax(disc.state_dict())
    back = discriminator_state_dict_from_jax(variables)
    assert sorted(back) == sorted(disc.state_dict())
    for k, v in disc.state_dict().items():
        assert torch.equal(back[k], v), k
    x = np.random.RandomState(frames).randn(3, frames, M + J).astype(
        np.float32)
    want = np.asarray(JaxDiscriminator(num_frames=frames).apply(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = disc(_nct(x)).numpy()
    assert got.shape == want.shape == (3, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_gradient_penalty_and_its_gradient_match_jax():
    disc = _disc(1)
    variables = discriminator_state_dict_to_jax(disc.state_dict())
    real, fake = _data(2)
    eps = np.random.RandomState(3).rand(B, 1, 1).astype(np.float32)
    jdisc = JaxDiscriminator(num_frames=T)

    def gp_fn(params):
        return jax_gradient_penalty(jdisc.apply, {"params": params},
                                    jnp.asarray(real), jnp.asarray(fake),
                                    eps=jnp.asarray(eps))

    jgp, jgrads = jax.value_and_grad(gp_fn)(variables["params"])
    want = discriminator_state_dict_from_jax({"params": jgrads})
    gp = gradient_penalty(disc, _nct(real), _nct(fake),
                          torch.from_numpy(eps))
    gp.backward()
    assert abs(float(gp) - float(jgp)) <= LOSS_RTOL * float(jgp)
    # d3's last InstanceNorm bias shifts what the LeakyReLU after it sees;
    # the critic's input gradient is piecewise constant in it: gradient 0
    zero = _conv_biases(disc) | {"d3.4.bias"}
    top = max(float(w.abs().max()) for w in want.values())
    for name, p in disc.named_parameters():
        w, g = want[name].numpy(), p.grad.numpy()
        if name in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) <= GRAD_RTOL * top
            continue
        assert _grad_err(w, g) <= GRAD_RTOL, name


def _pair(seed=0, **cfg_kw):
    """A port trainer and the JAX trainer's state holding its weights, both
    optimizers fresh."""
    kw = dict(lr=1e-4, gen_hop=1, lambda_gp=10.0, **cfg_kw)
    trainer = ResyncTrainer(ResyncConfig(**kw), n_mfcc=M, n_joints=J,
                            num_frames=T, device="cpu", seed=seed)
    with torch.no_grad():       # the critic's affine terms away from (1, 0)
        trainer.disc.load_state_dict(_disc(seed + 5).state_dict())
    jt = JaxTrainer(JaxResyncConfig(**kw), n_mfcc=M, n_joints=J,
                    num_frames=T)
    gv = convert_resync(trainer.gen.state_dict())
    dv = discriminator_state_dict_to_jax(trainer.disc.state_dict())
    state = ResyncTrainState(
        g_params=gv["params"], g_stats=gv["batch_stats"],
        d_params=dv["params"], g_opt=jt.g_tx.init(gv["params"]),
        d_opt=jt.d_tx.init(dv["params"]), step=jnp.zeros((), jnp.int32))
    return trainer, jt, state


def _check_step(module, want_sd, lr):
    """Parameters after one Adam step with b1 = 0: each moves by about lr
    times the sign of its (decayed) gradient, so an element whose gradient
    is rounding noise (the norm-fed conv biases) may move either way: every
    element within 2 lr, and 1e-6 for 99.9 % of the elements outside those
    biases."""
    zero = _conv_biases(module)
    close = total = 0
    for name, p in module.named_parameters():
        diff = np.abs(p.detach().numpy() - want_sd[name].numpy())
        assert diff.max() <= 2 * lr + 1e-7, (name, diff.max())
        if name not in zero:
            close += int((diff <= 1e-6).sum())
            total += diff.size
    assert close >= 0.999 * total, (close, total)


def test_one_iteration_matches_jax_steps():
    """One critic step then one generator step (gen_hop 1), against JAX's
    _d_step / _g_step on the same batch and interpolation points: losses,
    gradients against jax.grad of the same losses at the same points,
    BatchNorm running statistics (the critic step's generator pass runs in
    training mode and moves them, the generator step moves them again), and
    the parameters after Adam. One iteration only: GAN steps amplify
    rounding (tests/test_trainers_aux.py)."""
    trainer, jt, state = _pair(seed=3)
    x_knn, x_real = _data(4)
    eps = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (B, 1, 1)))
    lr = trainer.cfg.lr

    # -- critic: gradients of JAX's loss at the step's starting point -------
    gen = JaxResyncNet(out_features=J)
    jdisc = JaxDiscriminator(num_frames=T)
    fake_motion, _ = gen.apply({"params": state.g_params,
                                "batch_stats": state.g_stats},
                               jnp.asarray(x_knn), train=True,
                               mutable=["batch_stats"])
    fake = jnp.concatenate([jnp.asarray(x_knn[:, :, :M]), fake_motion], -1)

    def d_loss_fn(d_params):
        dv = {"params": d_params}
        return (jnp.mean(jdisc.apply(dv, fake))
                - jnp.mean(jdisc.apply(dv, jnp.asarray(x_real)))
                + 10.0 * jax_gradient_penalty(
                    jdisc.apply, dv, jnp.asarray(x_real), fake,
                    eps=jnp.asarray(eps)))

    d_grads = discriminator_state_dict_from_jax(
        {"params": jax.grad(d_loss_fn)(state.d_params)})
    state, jd_loss = jt._d_step(state, jnp.asarray(x_knn),
                                jnp.asarray(x_real), jnp.asarray(eps))
    d_loss = trainer.d_step(x_knn, x_real, torch.from_numpy(eps))
    assert abs(float(d_loss) - float(jd_loss)) <= \
        LOSS_RTOL * max(abs(float(jd_loss)), 1.0)
    zero = _conv_biases(trainer.disc)
    for name, p in trainer.disc.named_parameters():
        if name not in zero:
            assert _grad_err(d_grads[name].numpy(), p.grad.numpy()) <= \
                GRAD_RTOL, name
    _check_step(trainer.disc, discriminator_state_dict_from_jax(
        {"params": state.d_params}), lr)
    gen_sd = resync_state_dict_from_jax({"params": state.g_params,
                                         "batch_stats": state.g_stats})
    bufs = dict(trainer.gen.named_buffers())
    for name in gen_sd:
        if "running" in name:
            np.testing.assert_allclose(bufs[name].numpy(),
                                       gen_sd[name].numpy(), rtol=0,
                                       atol=STATS_ATOL, err_msg=name)

    # -- generator: from the statistics the critic step left ----------------
    def g_loss_fn(g_params):
        motion, _ = gen.apply({"params": g_params,
                               "batch_stats": state.g_stats},
                              jnp.asarray(x_knn), train=True,
                              mutable=["batch_stats"])
        f = jnp.concatenate([jnp.asarray(x_knn[:, :, :M]), motion], -1)
        return (-jnp.mean(jdisc.apply({"params": state.d_params}, f))
                + 0.1 * jnp.mean(jnp.abs(motion - x_knn[:, :, M:])))

    g_grads = resync_state_dict_from_jax(
        {"params": jax.grad(g_loss_fn)(state.g_params),
         "batch_stats": state.g_stats})
    # the critic the generator step scores against is JAX's updated one; the
    # port's differs from it by Adam's sign noise on the zero-gradient biases
    trainer.disc.load_state_dict(discriminator_state_dict_from_jax(
        {"params": state.d_params}))
    state, jg_loss = jt._g_step(state, jnp.asarray(x_knn),
                                jnp.asarray(x_real))
    g_loss = trainer.g_step(x_knn, x_real)
    assert abs(float(g_loss) - float(jg_loss)) <= \
        LOSS_RTOL * max(abs(float(jg_loss)), 1.0)
    zero = _conv_biases(trainer.gen)
    top = max(float(w.abs().max()) for w in g_grads.values())
    for name, p in trainer.gen.named_parameters():
        w, g = g_grads[name].numpy(), p.grad.numpy()
        if name in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) <= GRAD_RTOL * top
            continue
        assert _grad_err(w, g) <= GRAD_RTOL, name
    want = resync_state_dict_from_jax({"params": state.g_params,
                                       "batch_stats": state.g_stats})
    _check_step(trainer.gen, want, lr)
    bufs = dict(trainer.gen.named_buffers())
    for name in want:
        if "running" in name:
            np.testing.assert_allclose(bufs[name].numpy(), want[name].numpy(),
                                       rtol=0, atol=STATS_ATOL, err_msg=name)
    assert trainer.step == int(state.step) == 1


def test_train_iteration_draws_eps_and_keeps_losses_on_device():
    trainer = ResyncTrainer(ResyncConfig(gen_hop=2), n_mfcc=M, n_joints=J,
                            num_frames=T, device="cpu", seed=1)
    x_knn, x_real = _data(5)
    logs = trainer.train_iteration(x_knn, x_real, 0)
    assert sorted(logs) == ["d_loss", "g_loss"]
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in logs.values())
    assert sorted(trainer.train_iteration(x_knn, x_real, 1)) == ["d_loss"]
    a = ResyncTrainer(ResyncConfig(), M, J, T, device="cpu", seed=4)
    b = ResyncTrainer(ResyncConfig(), M, J, T, device="cpu", seed=4)
    assert torch.equal(a.draw_eps(B), b.draw_eps(B))
    assert a.draw_eps(B).shape == (B, 1, 1)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ResyncTrainer(ResyncConfig(), M, J, T, mesh_shape=(2,), device="cpu")


def test_train_resync_cli_directory_feeds_generate_and_resync_apply(
        tmp_path):
    """train-resync prints JAX's log lines at the same iterations (the
    batches come from the same RandomState), writes <out>/latest.pt with the
    generator under model_resync_state_dict, and the directory is what
    load_resync_checkpoint, resync-apply and generate --resync read; a
    directory without latest.pt (an orbax checkpoint) raises, naming what
    it holds."""
    rng = np.random.RandomState(6)
    n_joints, n_mfcc = 135, 13
    knn = rng.randn(6, 48, n_mfcc + n_joints).astype(np.float32)
    real = rng.randn(6, 48, n_mfcc + n_joints).astype(np.float32)
    data = str(tmp_path / "pairs.npz")
    np.savez(data, knn=knn, real=real)
    out = str(tmp_path / "resync")
    lines = []
    for cli, extra in ((jax_cli, []), (port_cli, ["--out", out, "--device",
                                                  "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(["train-resync", "--data", data, "--iters", "4",
                 "--batch-size", "3"] + extra)
        lines.append([ln.split(":")[0] for ln in buf.getvalue().splitlines()
                      if ln.startswith("iter")])
    assert lines[0] == lines[1] == ["iter 0", "iter 1", "iter 2", "iter 3"]
    state = restore_checkpoint(out, "latest")
    assert state["step"] == 4
    assert {"model_resync_state_dict", "model_disc_state_dict",
            "optimizer_resync", "optimizer_disc"} <= set(state)
    gen = load_resync_checkpoint(out, device="cpu")
    assert not gen.training
    for k, v in state["model_resync_state_dict"].items():
        assert torch.equal(gen.state_dict()[k], v), k

    # resync-apply and generate --resync take the directory
    test_path = str(tmp_path / "test.npz")
    np.savez(test_path, mfcc=rng.randn(2, 48, 14).astype(np.float32))
    train_path = str(tmp_path / "train.npz")
    np.savez(train_path, mfcc=rng.randn(3, 48, 14).astype(np.float32),
             body=rng.randn(3, 48, n_joints).astype(np.float32))
    knn_path = str(tmp_path / "knn.npz")
    np.savez(knn_path, knn_pred=rng.randn(2, n_joints, 48).astype(
        np.float32))
    stage2 = str(tmp_path / "stage2.npz")
    port_cli(["resync-apply", "--knn", knn_path, "--test-data", test_path,
              "--train-database", train_path, "--checkpoint", out,
              "--out", stage2, "--device", "cpu"])
    assert np.isfinite(np.load(stage2)["knn_pred"]).all()
    args = write_end2end_inputs(tmp_path, rng, seconds=4.5)
    port_cli(args + ["--resync", out, "--train-database", train_path,
                     "--out", str(tmp_path / "gen"), "--device", "cpu"])
    assert read_generated(str(tmp_path / "gen"))[0]
    orbax = tmp_path / "orbax_dir"
    (orbax / "latest").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="latest.pt"):
        load_resync_checkpoint(str(orbax), device="cpu")
