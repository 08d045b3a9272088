"""PAE training: the port's BatchNorm training step against flax's, the
cosine-restart schedule against optax's, PAE gradients against jax.grad,
three PAETrainer steps against the JAX package's (weights carried across
with its converter, both optimizers fresh), and the train-pae CLI whose
checkpoint feeds the phase extractor."""
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import linen as fnn

from qpgesture_tpu.core.config import PAEConfig as JaxPAEConfig
from qpgesture_tpu.models.pae import PAE as JaxPAE
from qpgesture_tpu.models.pae import velocity_input as jax_velocity_input
from qpgesture_tpu.models.torch_convert import convert_pae
from qpgesture_tpu.parallel.mesh import make_mesh
from qpgesture_tpu.train.train_pae import PAETrainer as JaxPAETrainer
from qpgesture_tpu.train.train_pae import PAETrainState
from qpgesture_tpu.train.train_pae import \
    cyclic_cosine_restarts as jax_restarts
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.core.config import PAEConfig
from qpgesture_tpu_torch.models.batchnorm import BatchNorm1d
from qpgesture_tpu_torch.models.convert import (load_pae_checkpoint,
                                                pae_state_dict_from_jax)
from qpgesture_tpu_torch.models.pae import PhaseExtractor
from qpgesture_tpu_torch.train.checkpoints import restore_checkpoint
from qpgesture_tpu_torch.train.data import WindowedDataset
from qpgesture_tpu_torch.train.train_pae import (PAETrainer,
                                                 cyclic_cosine_restarts,
                                                 pae_loss)
from qpgesture_tpu_torch.utils.metrics_log import ScalarHistory

SMALL = dict(frames=24, joints=3, channels_per_joint=3, phase_channels=2,
             keys=13, window=4.0, restart_period=2, restart_mult=2)
# losses: float32 on both sides, other summation orders
LOSS_RTOL = 1e-5
# gradients, relative to each tensor's largest |g|
GRAD_RTOL = 1e-4
# BatchNorm running statistics
STATS_ATOL = 1e-6
# biases feeding a training-mode BatchNorm: their gradient is 0 (the batch
# mean removes them), so what either side computes is rounding noise
BN_FED = {"conv1.bias", "conv2.bias", "deconv1.bias"} | {
    f"fc.{i}.bias" for i in range(SMALL["phase_channels"])}


def _windows(rng, n=8, t=SMALL["frames"], c=9):
    phase = rng.rand(n, 1, c) * 6.3
    t_ax = np.linspace(0, 4, t)[None, :, None]
    return (np.sin(2.1 * t_ax + phase) + 0.1 * rng.randn(n, t, c)
            ).astype(np.float32)


@pytest.mark.parametrize("shape", [(8, 5), (1, 5), (6, 5, 7), (1, 3, 9)])
def test_batchnorm_training_step_matches_flax(shape):
    """Output and running statistics of one training step: flax moves the
    running variance towards the biased batch variance (torch's own
    BatchNorm1d towards the unbiased one) and takes a batch of one."""
    rng = np.random.RandomState(len(shape) + shape[0])
    x = (1.5 + 2 * rng.randn(*shape)).astype(np.float32)
    C = shape[1]
    bn = BatchNorm1d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.randn(C).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.randn(C).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.randn(C).astype(
            np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.rand(C).astype(
            np.float32) + 0.5))
    flax_bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, axis=-1,
                            use_running_average=False)
    xt = np.moveaxis(x, 1, -1)        # flax normalizes the last axis
    variables = {"params": {"scale": bn.weight.detach().numpy(),
                            "bias": bn.bias.detach().numpy()},
                 "batch_stats": {"mean": bn.running_mean.numpy().copy(),
                                 "var": bn.running_var.numpy().copy()}}
    want, upd = flax_bn.apply(variables, jnp.asarray(xt),
                              mutable=["batch_stats"])
    bn.train()
    got = bn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), np.asarray(want),
                               rtol=0, atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=0, atol=STATS_ATOL)
    assert int(bn.num_batches_tracked) == 1
    bn.eval()       # evaluation is torch's own path on the running stats
    ref = torch.nn.BatchNorm1d(C)
    ref.load_state_dict(bn.state_dict())
    ref.eval()
    assert torch.equal(bn(torch.from_numpy(x)), ref(torch.from_numpy(x)))


def test_cyclic_cosine_restarts_matches_optax():
    """Value by value at and around every boundary (each period ends at 0,
    the next starts at the base rate) and past the last cycle; optax
    evaluated in float64, 1e-7 relative (1e-7 of the base rate where the
    value is 0)."""
    base = 1e-4
    for spe, period, mult in ((1, 10, 2), (3, 2, 2), (7, 1, 3)):
        got_fn = cyclic_cosine_restarts(base, spe, period, mult)
        with jax.enable_x64(True):
            want_fn = jax_restarts(base, spe, period, mult)
            starts, p, s = [], period * spe, 0
            for _ in range(9):
                starts.append(s)
                s += p
                p = int(p * mult)
            steps = sorted({b + d for b in starts for d in (-2, -1, 0, 1, 2)
                            if b + d >= 0} | set(range(0, 3 * period * spe)))
            for step in steps:
                want = float(want_fn(step))
                got = got_fn(step)
                assert abs(got - want) <= 1e-7 * (abs(want) or base), \
                    (spe, step, got, want)
        assert got_fn(period * spe) == base and got_fn(period * spe - 1) > 0


def _carry(trainer):
    """The port trainer's PAE as JAX PAE variables."""
    return convert_pae(trainer.model.state_dict(), SMALL["phase_channels"])


def _jax_cfg():
    return JaxPAEConfig(**SMALL)


def test_pae_gradients_match_jax_grad():
    trainer = PAETrainer(PAEConfig(**SMALL), device="cpu", seed=1)
    variables = _carry(trainer)
    x = _windows(np.random.RandomState(1))
    jmodel = JaxPAE(_jax_cfg())

    def loss_fn(params):
        xv = jax_velocity_input(jnp.asarray(x))
        (y, *_), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, xv,
            train=True, mutable=["batch_stats"])
        return 300.0 * jnp.mean((y - xv) ** 2)

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    want = pae_state_dict_from_jax({"params": jgrads,
                                    "batch_stats": variables["batch_stats"]},
                                   PAEConfig(**SMALL))
    trainer.model.train()
    loss = pae_loss(trainer.model, torch.from_numpy(x))
    loss.backward()
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * float(jloss)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in trainer.model.named_parameters():
        w, g = want[name].numpy(), p.grad.numpy()
        if name in BN_FED:      # both 0 to 1e-4 of the model's largest |g|
            assert max(np.abs(g).max(), np.abs(w).max()) <= GRAD_RTOL * top
            continue
        err = np.abs(g - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (name, err)


def test_three_pae_trainer_steps_match_jax():
    """Losses 1e-5 relative; BatchNorm running statistics 1e-6; parameters
    after AdamW (lr from the cosine restarts: a period of 2 updates, so the
    rate goes base, base/2, base) held to 2 * lr per step for every element
    (Adam's first updates move an element whose gradient is within a few
    ulp of zero by up to lr: the BN_FED biases are all such elements) and to
    1e-6 for 99.9 % of the others. A BN_FED bias leaves the output alone but
    shifts its BatchNorm's running mean by 0.1 of itself per step: that
    shift, from the two sides' bias difference, is added to JAX's."""
    cfg = PAEConfig(**SMALL, learning_rate=1e-3)
    trainer = PAETrainer(cfg, steps_per_epoch=1, device="cpu", seed=2)
    jt = JaxPAETrainer(JaxPAEConfig(**SMALL, learning_rate=1e-3),
                       mesh=make_mesh(1), steps_per_epoch=1)
    variables = _carry(trainer)
    state = PAETrainState(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=jt.tx.init(variables["params"]),
                          step=jnp.zeros((), jnp.int32))
    rng = np.random.RandomState(3)
    x = _windows(rng)
    jev = float(jt.eval_step(state, x))
    assert abs(float(trainer.eval_step(x)) - jev) <= LOSS_RTOL * jev
    fed = {"conv1.bias": "bn_conv1", "conv2.bias": "bn_conv2",
           "deconv1.bias": "bn_deconv1"} | {
        f"fc.{i}.bias": f"bn.{i}" for i in range(SMALL["phase_channels"])}
    shift = {bn: 0.0 for bn in fed.values()}
    want = pae_state_dict_from_jax(variables, cfg)
    for i in range(3):
        params = dict(trainer.model.named_parameters())
        for bias, bn in fed.items():
            delta = params[bias].detach().numpy() - want[bias].numpy()
            shift[bn] = 0.9 * shift[bn] + 0.1 * delta
        x = _windows(rng)
        state, loss = jt.train_step(state, x)
        got = trainer.train_step(x)
        assert abs(float(got) - float(loss)) <= LOSS_RTOL * float(loss), i
        want = pae_state_dict_from_jax({"params": state.params,
                                        "batch_stats": state.batch_stats},
                                       cfg)
        for name, p in trainer.model.named_parameters():
            d = np.abs(p.detach().numpy() - want[name].numpy())
            assert d.max() <= 2e-3 * (i + 1), (i, name, d.max())
            assert name in BN_FED or np.mean(d <= 1e-6) >= 0.999, (i, name)
        for name, buf in trainer.model.named_buffers():
            if "running" in name:
                bn = name.rsplit(".", 1)[0]
                expect = want[name].numpy() + (
                    shift[bn] if name.endswith("running_mean") else 0.0)
                np.testing.assert_allclose(buf.numpy(), expect, rtol=0,
                                           atol=STATS_ATOL, err_msg=name)
    assert trainer.step == int(state.step) == 3


def test_train_pae_cli_feeds_the_phase_extractor(tmp_path, capsys):
    """train-pae on a WindowedDataset directory: {epoch:03d}.pt every
    save_per_epochs, latest.pt, scalars.jsonl, a falling loss; the checkpoint
    loads through the reference loader and drives PhaseExtractor."""
    rng = np.random.RandomState(4)
    data = str(tmp_path / "data")
    WindowedDataset(poses=_windows(rng, n=48)).save(data)
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"PAE": dict(SMALL, save_per_epochs=2,
                                    learning_rate=3e-3)}, f)
    out = str(tmp_path / "pae")
    port_cli(["train-pae", "--config", cfg_path, "--data", data, "--out",
              out, "--epochs", "5", "--batch-size", "8", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["001.pt", "003.pt", "latest.pt",
                                       "scalars.jsonl"]
    latest = restore_checkpoint(out, "latest")
    assert (latest["step"], latest["epoch"]) == (30, 4)
    losses = [v for _, _, v in ScalarHistory.read(
        os.path.join(out, "scalars.jsonl"))["loss"]]
    assert len(losses) == 5 and losses[-1] < losses[0]
    assert "epoch 4: loss" in capsys.readouterr().out

    model = load_pae_checkpoint(os.path.join(out, "latest.pt"),
                                PAEConfig(**SMALL), device="cpu")
    for k, v in latest["model_dict"].items():
        assert torch.equal(model.state_dict()[k], v), k
    pose = _windows(rng, n=1, t=100)[0]
    phase = PhaseExtractor(model, device="cpu").pose_to_phase(
        pose, np.zeros(9), np.ones(9))
    assert phase.shape == (100, 4, 2) and np.isfinite(phase).all()
