"""GRU-baseline training: the GeneratorGRU's loss and gradients, and three
End2EndTrainer steps against the JAX package's from carried weights (both
at dropout 0: the two packages' random draws cannot be equal; the JAX
trainer's model is patched inside the test only), the dropout between the
GRU layers drawn from the trainer's generator, and the train-vqvae ->
train-end2end -> generate --model end2end chain through the port's CLI."""
import functools
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from qpgesture_tpu.core.config import End2EndConfig as JaxEnd2EndConfig
from qpgesture_tpu.models.gru_baseline import GeneratorGRU as JaxGRU
from qpgesture_tpu.models.torch_convert import convert_generator_gru
from qpgesture_tpu.parallel.mesh import make_mesh
from qpgesture_tpu.train import train_end2end as jax_e2e
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.core.config import End2EndConfig
from qpgesture_tpu_torch.models.convert import (
    generator_gru_state_dict_from_jax, load_generator_gru_checkpoint)
from qpgesture_tpu_torch.train.checkpoints import restore_checkpoint
from qpgesture_tpu_torch.train.data import WindowedDataset
from qpgesture_tpu_torch.train.train_end2end import End2EndTrainer
from qpgesture_tpu_torch.utils.metrics_log import ScalarHistory

HIDDEN, CODES = 16, 32
# losses: float32 on both sides, five strided convs and a 2-layer GRU over
# 30 steps, other summation orders
LOSS_RTOL = 1e-5
# gradients, relative to each tensor's largest |g|
GRAD_RTOL = 1e-4
# BatchNorm running statistics of the WavEncoder
STATS_ATOL = 1e-6
# conv biases feeding a training-mode BatchNorm: gradient 0 (the batch mean
# removes them); what either side computes is rounding noise
BN_FED = {f"WavEncoder.feat_extractor.{k}.bias" for k in (0, 3, 6, 9)}
BN_OF = {f"WavEncoder.feat_extractor.{k}.bias":
         f"WavEncoder.feat_extractor.{k + 1}" for k in (0, 3, 6, 9)}


def _batch(rng, n=4):
    t = np.arange(64000) / 16000
    wav = 0.3 * np.sin(2 * np.pi * (120 + 40 * rng.rand(n, 1)) * t)
    wav = (wav + 0.05 * rng.randn(n, 64000)).astype(np.float32)
    return wav, rng.randint(0, CODES, (n, 30)).astype(np.int32)


def _cfg(**kw):
    return dict(hidden_size=HIDDEN, output_size=CODES, **kw)


def _jax_trainer(monkeypatch, lr):
    monkeypatch.setattr(jax_e2e, "GeneratorGRU",
                        functools.partial(JaxGRU, dropout=0.0))
    return jax_e2e.End2EndTrainer(JaxEnd2EndConfig(**_cfg(lr=lr)),
                                  mesh=make_mesh(1))


def test_gru_loss_and_gradients_match_jax_grad():
    trainer = End2EndTrainer(End2EndConfig(**_cfg()), device="cpu", seed=1)
    trainer.model.dropout = 0.0
    variables = convert_generator_gru(trainer.model.state_dict(), HIDDEN)
    wav, codes = _batch(np.random.RandomState(1))
    jmodel = JaxGRU(hidden=HIDDEN, output=CODES, dropout=0.0)

    def loss_fn(params):
        (_, loss), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(wav), jnp.asarray(codes), train=True,
            mutable=["batch_stats"])
        return loss

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    want = generator_gru_state_dict_from_jax(
        {"params": jgrads, "batch_stats": variables["batch_stats"]})
    trainer.model.train()
    logits, loss = trainer.model(torch.from_numpy(wav),
                                 torch.from_numpy(codes))
    assert logits.shape == (4, 30, CODES)
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


def test_three_end2end_trainer_steps_match_jax(monkeypatch):
    """Losses 1e-5 relative; Adam's first and second moments (the running
    sums of the gradients) 1e-4 of each tensor's largest; the WavEncoder's
    BatchNorm statistics 1e-6 (a BN_FED bias, moved by Adam's noise, shifts
    its running mean by 0.1 of itself per step: that shift is added to
    JAX's). Parameters within 2 * lr per step: with beta1 0.99 the update
    m / (v^0.5 + eps) of an element whose gradients nearly cancel, or sit
    within a few ulp of zero, carries the gradients' rounding up to lr. The
    learning rate is End2EndConfig's, 2e-4."""
    lr = End2EndConfig().lr
    trainer = End2EndTrainer(End2EndConfig(**_cfg(lr=lr)), device="cpu",
                             seed=2)
    trainer.model.dropout = 0.0
    jt = _jax_trainer(monkeypatch, lr)
    variables = convert_generator_gru(trainer.model.state_dict(), HIDDEN)
    state = jax_e2e.End2EndTrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jt.tx.init(variables["params"]),
        step=jnp.zeros((), jnp.int32))
    rng = np.random.RandomState(3)
    shift = {bn: 0.0 for bn in BN_OF.values()}
    want = generator_gru_state_dict_from_jax(variables)
    for i in range(3):
        params = dict(trainer.model.named_parameters())
        for bias, bn in BN_OF.items():
            delta = params[bias].detach().numpy() - want[bias].numpy()
            shift[bn] = 0.9 * shift[bn] + 0.1 * delta
        wav, codes = _batch(rng)
        state, loss = jt.train_step(state, wav, codes,
                                    jax.random.PRNGKey(i))
        got = trainer.train_step(wav, codes)
        assert abs(float(got) - float(loss)) <= LOSS_RTOL * float(loss), i
        want = generator_gru_state_dict_from_jax(
            {"params": state.params, "batch_stats": state.batch_stats})
        adam = state.opt_state[0]
        moments = [generator_gru_state_dict_from_jax(
            {"params": tree, "batch_stats": state.batch_stats})
            for tree in (adam.mu, adam.nu)]
        for name, p in trainer.model.named_parameters():
            d = np.abs(p.detach().numpy() - want[name].numpy())
            assert d.max() <= 2 * lr * (i + 1), (i, name, d.max())
            if name in BN_FED:
                continue
            opt = trainer.opt.state[p]
            for key, m in zip(("exp_avg", "exp_avg_sq"), moments):
                w = m[name].numpy()
                err = np.abs(opt[key].numpy() - w).max()
                assert err <= GRAD_RTOL * np.abs(w).max(), (i, name, key)
        for name, buf in trainer.model.named_buffers():
            if "running" in name:
                bn = name.rsplit(".", 1)[0]
                expect = want[name].numpy() + (
                    shift[bn] if name.endswith("running_mean") else 0.0)
                np.testing.assert_allclose(buf.numpy(), expect, rtol=0,
                                           atol=STATS_ATOL, err_msg=name)
    assert trainer.step == int(state.step) == 3
    wav, codes = _batch(rng)
    ev, jev = trainer.eval_step(wav, codes), jt.eval_step(state, wav, codes)
    assert np.isfinite(float(ev)) and np.isfinite(float(jev))


def test_dropout_sits_between_the_gru_layers():
    """In training, layer 0's output times a keep mask (1 - p of the
    elements, scaled by 1 / (1 - p)) drawn from the caller's generator feeds
    layer 1, as nn.GRU(dropout=p) applies it; nothing after the last layer,
    nothing in evaluation; the same seed draws the same masks."""
    p = 0.25
    trainer = End2EndTrainer(End2EndConfig(**_cfg()), device="cpu", seed=4)
    trainer.model.dropout = p
    model = trainer.model.train()
    wav, codes = _batch(np.random.RandomState(4))
    wav_t = torch.from_numpy(wav)

    def run(seed):
        return model(wav_t, torch.from_numpy(codes),
                     generator=torch.Generator().manual_seed(seed))

    (a, la), (b, lb), (c, _) = run(7), run(7), run(8)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert not torch.equal(a, c)

    # the same by hand: two one-layer GRUs with the layers' weights
    gru = model.project
    layers = []
    for layer in range(2):
        one = torch.nn.GRU(gru.input_size if layer == 0 else 2 * HIDDEN,
                           HIDDEN, 1, batch_first=True, bidirectional=True)
        one.load_state_dict({k.replace(f"_l{layer}", "_l0"): v
                             for k, v in gru.state_dict().items()
                             if f"_l{layer}" in k})
        layers.append(one)
    with torch.no_grad():
        g = torch.Generator().manual_seed(7)
        h = layers[0](model.WavEncoder(wav_t))[0]
        keep = torch.rand(h.shape, generator=g) >= p
        assert abs(float(keep.float().mean()) - (1 - p)) < 0.02
        h = layers[1](h * keep / (1 - p))[0]
        h = h[..., :HIDDEN] + h[..., HIDDEN:]
        want = model.out(model.norm(h))
    torch.testing.assert_close(a.detach(), want, rtol=0, atol=1e-6)
    model.eval()
    with torch.no_grad():
        e1 = model(wav_t)
        torch.testing.assert_close(e1, model(wav_t, generator=torch.Generator(
        ).manual_seed(1)), rtol=0, atol=0)


def test_train_cli_chain_to_generate_end2end(tmp_path, capsys):
    """train-vqvae and train-end2end through the port's CLI; generate
    --model end2end reads both output directories (best.pt and latest.pt)
    and samples what the trained GRU samples."""
    from test_build_db_cli import make_beat_like_bvh
    from qpgesture_tpu_torch.cli import _end2end_windows
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    from qpgesture_tpu_torch.motion.pipeline import MotionPipeline

    rng = np.random.RandomState(5)
    vq = dict(width=16, emb_width=16, l_bins=CODES, depth=1, input_dim=135)
    cfg_path = str(tmp_path / "cfg.yml")
    val = str(tmp_path / "val")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"VQVAE": vq, "end2end": _cfg(), "batch_size": 4,
                        "val_data_path": val}, f)
    poses = lambda n: (0.5 * rng.randn(n, 48, 135)).astype(np.float32)
    WindowedDataset(poses=poses(8)).save(str(tmp_path / "vqdata"))
    WindowedDataset(poses=poses(4)).save(val)
    wav, codes = _batch(rng, n=10)
    WindowedDataset(poses=poses(10), audio=wav, codes=codes).save(
        str(tmp_path / "e2edata"))
    vq_out, e2e_out = str(tmp_path / "vq"), str(tmp_path / "e2e")
    port_cli(["train-vqvae", "--config", cfg_path, "--data",
              str(tmp_path / "vqdata"), "--out", vq_out, "--epochs", "2",
              "--device", "cpu"])
    port_cli(["train-end2end", "--config", cfg_path, "--data",
              str(tmp_path / "e2edata"), "--out", e2e_out, "--epochs", "3",
              "--batch-size", "4", "--device", "cpu"])
    assert sorted(os.listdir(e2e_out)) == ["latest.pt", "scalars.jsonl"]
    latest = restore_checkpoint(e2e_out, "latest")
    assert (latest["step"], latest["epoch"]) == (6, 2)
    assert len(ScalarHistory.read(os.path.join(e2e_out, "scalars.jsonl"))
               ["loss"]) == 3
    assert "epoch 2: loss" in capsys.readouterr().out

    pipe = MotionPipeline(fps=60).fit(parse_bvh(make_beat_like_bvh(rng, 300)))
    pipe_path = str(tmp_path / "pipeline.json")
    with open(pipe_path, "w") as f:
        f.write(pipe.to_json())
    speech = (0.2 * rng.randn(16000 * 9)).astype(np.float32)
    wav_path = str(tmp_path / "in.npz")
    np.savez(wav_path, wav=speech)
    out = str(tmp_path / "gen")
    port_cli(["generate", "--wav", wav_path, "--model", "end2end",
              "--end2end-checkpoint", e2e_out, "--vqvae-checkpoint", vq_out,
              "--pipeline", pipe_path, "--config", cfg_path, "--prefix",
              "e2e", "--out", out, "--device", "cpu"])
    got = np.load(os.path.join(out, "code_e2e.npy"))
    gen = load_generator_gru_checkpoint(e2e_out, device="cpu")
    want = gen.sample(torch.from_numpy(_end2end_windows(speech))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 30)
    assert parse_bvh(os.path.join(out, "e2e_generated.bvh")
                     ).values.shape[0] == 3 * 240

    with pytest.raises(SystemExit, match="audio.npy and codes.npy"):
        port_cli(["train-end2end", "--config", cfg_path, "--data",
                  str(tmp_path / "vqdata"), "--device", "cpu"])
