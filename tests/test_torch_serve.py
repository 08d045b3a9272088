"""The slice as a whole: the port's ServingPipeline and its match -> decode
CLI against the JAX package's, on the same fixtures and weights."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu.core.config import MATCH_PRESETS, VQVAEConfig
from qpgesture_tpu.core.schemas import load_result, save_codes, save_wavvq
from qpgesture_tpu.match import database as jax_db
from qpgesture_tpu.match.engine import CodeKNNEngine as JaxEngine
from qpgesture_tpu.models.torch_convert import convert_vqvae
from qpgesture_tpu.models.vqvae import VQVAE as JaxVQVAE
from qpgesture_tpu.motion.bvh import parse_bvh
from qpgesture_tpu.motion.pipeline import MotionPipeline
from qpgesture_tpu.serve import ServingPipeline as JaxServing
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.core.config import VQVAEConfig as PortVQVAEConfig
from qpgesture_tpu_torch.match import database as port_db
from qpgesture_tpu_torch.match.engine import CodeKNNEngine as PortEngine
from qpgesture_tpu_torch.models.vqvae import VQVAE
from qpgesture_tpu_torch.serve import ServingPipeline as PortServing

from fixtures import make_fixture
from test_torch_staging import port_config, stage

sys.path.insert(0, os.path.dirname(__file__))
from test_motion import make_bvh_text  # noqa: E402

TINY = dict(width=16, depth=1, emb_width=16, l_bins=64, sample_length=30)


def _port_vqvae(input_dim=135, seed=0):
    torch.manual_seed(seed)
    model = VQVAE(PortVQVAEConfig(input_dim=input_dim, **TINY), device="cpu")
    rng = np.random.RandomState(seed)
    model.init_codebook_from_batch(
        torch.from_numpy(rng.randn(2, 240, input_dim).astype(np.float32)),
        rng)
    return model


@pytest.mark.parametrize("preset", ["wavvq", "mfcc"])
def test_serve_matches_jax(preset):
    """Codes equal; poses within 1e-4 (float32 decode, summation order)."""
    rng = np.random.RandomState(31)
    fx = make_fixture(rng, n_seq=4, n_test=3, codebook=64)
    cfg = dataclasses.replace(MATCH_PRESETS[preset], codebook_size=64)
    jdb, ta, tc = stage(jax_db, cfg, fx)
    pdb, _, _ = stage(port_db, port_config(cfg), fx)
    model = _port_vqvae()
    vq_cfg = VQVAEConfig(input_dim=135, **TINY)
    params, cb = convert_vqvae(model.state_dict(), vq_cfg)
    mean = rng.randn(135).astype(np.float32)
    std = rng.rand(135).astype(np.float32) + 0.5

    jax_serving = JaxServing(JaxEngine(cfg, jdb), JaxVQVAE(vq_cfg), params,
                             cb, data_mean=mean, data_std=std)
    port_serving = PortServing(PortEngine(port_config(cfg), pdb,
                                          device="cpu"), model,
                               data_mean=mean, data_std=std)
    for init_code in (0, 5):
        want_codes, want_poses = jax_serving.serve(ta, tc,
                                                   init_code=init_code)
        codes, poses = port_serving.serve(ta, tc, init_code=init_code)
        np.testing.assert_array_equal(codes, want_codes)
        assert poses.shape == (3 * 240, 135)
        np.testing.assert_allclose(poses, want_poses, rtol=0, atol=1e-4)


def _write_inputs(tmp_path, fx, rng):
    paths = {k: str(tmp_path / f"{k}.npz") for k in
             ("db", "codes", "sig", "wavvq", "test_wavvq", "test_bundle")}
    fx["bundle"].save(paths["db"])
    save_codes(paths["codes"], fx["codes"])
    fx["signature"].save(paths["sig"])
    save_wavvq(paths["wavvq"], fx["wavvq"])
    save_wavvq(paths["test_wavvq"], fx["test_wavvq"])
    dataclasses.replace(fx["bundle"], context=rng.randn(
        2, 30, 1, 384).astype(np.float32)).save(paths["test_bundle"])
    return paths


def test_cli_match_and_decode_match_jax(tmp_path):
    """result.npz codes equal; BVH headers equal and motion values within
    1e-3 (the BVH text carries 6 decimals)."""
    rng = np.random.RandomState(8)
    fx = make_fixture(rng, n_seq=4, n_test=2, codebook=64)
    p = _write_inputs(tmp_path, fx, rng)
    match_args = ["match", "--train-database", p["db"],
                  "--train-codebook", p["codes"],
                  "--codebook-signature", p["sig"],
                  "--train-wavvq", p["wavvq"],
                  "--test-wavvq", p["test_wavvq"],
                  "--test-data", p["test_bundle"], "--preset", "wavvq"]
    jax_result = str(tmp_path / "jax_result.npz")
    port_result = str(tmp_path / "port_result.npz")
    jax_cli(match_args + ["--out", jax_result])
    port_cli(match_args + ["--out", port_result, "--device", "cpu"])
    np.testing.assert_array_equal(load_result(port_result),
                                  load_result(jax_result))

    # decode through a 6-joint skeleton (54 channels), with a reference-
    # layout .bin checkpoint that both CLIs read
    text, _ = make_bvh_text(rng, n_frames=48, fps=120)
    pipe = MotionPipeline(
        target_joints=["Spine", "Spine1", "RightShoulder", "RightArm",
                       "LeftShoulder", "LeftArm"], fps=60).fit(
        parse_bvh(text))
    pipe_path = str(tmp_path / "pipeline.json")
    with open(pipe_path, "w") as f:
        f.write(pipe.to_json())
    model = _port_vqvae(input_dim=54, seed=4)
    ckpt = str(tmp_path / "vqvae.bin")
    torch.save({"model_dict": model.state_dict()}, ckpt)
    cfg_path = str(tmp_path / "config.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"VQVAE": dict(TINY, input_dim=54),
                        "data_mean": [0.1] * 54, "data_std": [2.0] * 54}, f)
    decode_args = ["decode", "--result", jax_result, "--checkpoint", ckpt,
                   "--pipeline", pipe_path, "--config", cfg_path,
                   "--prefix", "t"]
    jax_cli(decode_args + ["--out", str(tmp_path / "jax_out")])
    port_cli(decode_args + ["--out", str(tmp_path / "port_out"),
                            "--device", "cpu"])
    texts = []
    for d in ("jax_out", "port_out"):
        with open(tmp_path / d / "t_generated.bvh") as f:
            texts.append(f.read())
    head = [t.split("MOTION")[0] for t in texts]
    assert head[0] == head[1]
    want, got = parse_bvh(texts[0]), parse_bvh(texts[1])
    assert got.values.shape == want.values.shape == (2 * 240,
                                                     len(want.channel_names))
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        np.load(tmp_path / "port_out" / "t_generated.npy"),
        np.load(tmp_path / "jax_out" / "t_generated.npy"), rtol=0,
        atol=1e-3)
