"""The end-to-end GRU baseline ("w/o motion matching"): random port modules
with the reference's parameter names, converted to flax by the JAX
package's own converters, give the JAX models' logits and codes; the
windowing and the checkpoint loaders; generate --model end2end through both
CLIs on the same files."""
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from qpgesture_tpu.cli import _end2end_windows as jax_windows
from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu.models.gru_baseline import GeneratorGRU as JaxGRU
from qpgesture_tpu.models.gru_baseline import GeneratorLinear as JaxLinear
from qpgesture_tpu.models.torch_convert import (convert_generator_gru,
                                                convert_generator_linear)
from qpgesture_tpu_torch.cli import _end2end_windows
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.models.convert import (
    generator_gru_state_dict_from_jax, load_generator_gru_checkpoint)
from qpgesture_tpu_torch.models.gru_baseline import (GeneratorGRU,
                                                     GeneratorLinear)
from qpgesture_tpu_torch.motion.bvh import parse_bvh
from qpgesture_tpu_torch.motion.pipeline import MotionPipeline

from test_build_db_cli import make_beat_like_bvh
from test_torch_serve import TINY, _port_vqvae

# float32 on both sides: five strided convs, a 2-layer GRU over 30 steps
# and a LayerNorm, other summation orders
LOGIT_ATOL = 1e-5


def randomize_batchnorm(model: torch.nn.Module, seed: int) -> None:
    """Running statistics other than (0, 1), so that eval mode exercises
    the converted statistics."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features,
                                                       generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.num_features,
                                                     generator=g))


def port_gru(seed: int, hidden: int = 200, output: int = 512):
    torch.manual_seed(seed)
    model = GeneratorGRU(hidden=hidden, output=output, device="cpu")
    randomize_batchnorm(model, seed)
    return model


@pytest.mark.parametrize("seconds,max_frames", [(9.0, 0), (3.0, 0),
                                                (60.5, 0), (60.5, 3600),
                                                (8.0, 250)])
def test_end2end_windows_match_jax(seconds, max_frames):
    wav = np.random.RandomState(1).randn(int(16000 * seconds)).astype(
        np.float32)
    np.testing.assert_array_equal(_end2end_windows(wav, max_frames),
                                  jax_windows(wav, max_frames))


def _wins(n, seed=0):
    return (0.2 * np.random.RandomState(seed).randn(n, 64000)).astype(
        np.float32)


def test_generator_gru_matches_jax():
    model = port_gru(3)
    variables = convert_generator_gru(model.state_dict())
    wins = _wins(3)
    want = np.asarray(JaxGRU(hidden=200, output=512).apply(
        variables, jnp.asarray(wins), train=False)[0])
    with torch.no_grad():
        got = model(torch.from_numpy(wins)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    codes = model.sample(torch.from_numpy(wins)).numpy()
    np.testing.assert_array_equal(codes, want.argmax(-1))
    jcodes = np.asarray(JaxGRU(hidden=200, output=512).sample(
        variables, jnp.asarray(wins)))
    np.testing.assert_array_equal(codes, jcodes)


def test_generator_linear_matches_jax():
    torch.manual_seed(4)
    model = GeneratorLinear(output=512, device="cpu")
    randomize_batchnorm(model, 4)
    variables = convert_generator_linear(model.state_dict())
    wins = _wins(2, seed=1)
    want = np.asarray(JaxLinear(output=512).apply(
        variables, jnp.asarray(wins), train=False)[0])
    with torch.no_grad():
        got = model(torch.from_numpy(wins)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(model.sample(torch.from_numpy(wins)).numpy(),
                                  want.argmax(-1))


def test_state_dict_round_trip_and_checkpoint_layouts(tmp_path):
    model = port_gru(5, hidden=16, output=64)
    sd = model.state_dict()
    back = generator_gru_state_dict_from_jax(convert_generator_gru(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    wins = torch.from_numpy(_wins(2, seed=2))
    want = model.sample(wins)
    for name, ckpt in (("dict", {"model_dict": sd, "epoch": 3}),
                       ("bare", sd),
                       ("parallel", {"model_dict": {
                           f"module.{k}": v for k, v in sd.items()}})):
        path = str(tmp_path / f"{name}.bin")
        torch.save(ckpt, path)
        loaded = load_generator_gru_checkpoint(path, device="cpu")
        assert not loaded.training
        assert (loaded.hidden, loaded.out.out_features) == (16, 64)
        assert torch.equal(loaded.sample(wins), want), name
    # a directory is a train-end2end output: without the port's latest.pt
    # (an orbax checkpoint of the JAX trainer) it raises, naming what it holds
    orbax = tmp_path / "orbax_dir"
    (orbax / "latest").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match=r"latest\.pt.*\['latest'\]"):
        load_generator_gru_checkpoint(str(orbax), device="cpu")


def write_end2end_inputs(tmp_path, rng, seconds: float = 9.0):
    """A 16 kHz wav (npz), a reference-layout Generator_gru .bin, a 135-dim
    VQ-VAE .bin, a pipeline over a BEAT-like 15-joint skeleton and a config
    naming their widths. Returns the generate arguments before --out."""
    gru = port_gru(6, hidden=16, output=64)
    e2e_path = str(tmp_path / "end2end.bin")
    torch.save({"model_dict": gru.state_dict()}, e2e_path)
    vq_path = str(tmp_path / "vqvae.bin")
    torch.save({"model_dict": _port_vqvae(input_dim=135, seed=7).state_dict()},
               vq_path)
    pipe = MotionPipeline(fps=60).fit(parse_bvh(make_beat_like_bvh(rng, 600)))
    pipe_path = str(tmp_path / "pipeline.json")
    with open(pipe_path, "w") as f:
        f.write(pipe.to_json())
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"VQVAE": dict(TINY, input_dim=135),
                        "end2end": {"hidden_size": 16, "output_size": 64},
                        "data_mean": [0.0] * 135, "data_std": [1.0] * 135}, f)
    wav_path = str(tmp_path / "in.npz")
    np.savez(wav_path, wav=(0.2 * rng.randn(int(16000 * seconds))).astype(
        np.float32))
    return ["generate", "--wav", wav_path, "--model", "end2end",
            "--end2end-checkpoint", e2e_path, "--vqvae-checkpoint", vq_path,
            "--pipeline", pipe_path, "--config", cfg_path, "--prefix", "e2e"]


def read_generated(out_dir: str):
    with open(os.path.join(out_dir, "e2e_generated.bvh")) as f:
        text = f.read()
    return text, np.load(os.path.join(out_dir, "code_e2e.npy"))


def test_generate_end2end_matches_jax(tmp_path):
    """9 s -> 3 windows (the padded tail kept); --max-frames 240 keeps 1.
    code_<prefix>.npy equal, BVH headers equal, motion within 1e-3 (the
    BVH text carries 6 decimals)."""
    rng = np.random.RandomState(21)
    args = write_end2end_inputs(tmp_path, rng)
    for extra, n_win in (([], 3), (["--max-frames", "240"], 1)):
        outs = []
        for name, cli, dev in (("jax", jax_cli, []),
                               ("port", port_cli, ["--device", "cpu"])):
            out_dir = str(tmp_path / f"{name}{len(extra)}")
            cli(args + extra + ["--out", out_dir] + dev)
            outs.append(read_generated(out_dir))
        (jtext, jcodes), (ptext, pcodes) = outs
        assert pcodes.dtype == jcodes.dtype
        assert pcodes.shape == (n_win, 30)
        np.testing.assert_array_equal(pcodes, jcodes)
        assert ptext.split("MOTION")[0] == jtext.split("MOTION")[0]
        want, got = parse_bvh(jtext), parse_bvh(ptext)
        assert got.values.shape == want.values.shape == (n_win * 240,
                                                         want.values.shape[1])
        np.testing.assert_allclose(got.values, want.values, rtol=0,
                                   atol=1e-3)
    i = args.index("--end2end-checkpoint")
    with pytest.raises(SystemExit, match="end2end-checkpoint"):
        port_cli(args[:i] + args[i + 2:]
                 + ["--out", str(tmp_path / "x"), "--device", "cpu"])
