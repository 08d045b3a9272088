"""The raw-wav slice: device staging, vq-wav2vec, RawWavServer and the
generate CLI of the port against the JAX package's, on the same fixtures,
wavs and weights (tests/test_serve.py:96-173 is the model)."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu.core.config import MATCH_PRESETS, VQVAEConfig
from qpgesture_tpu.match import database as jax_db
from qpgesture_tpu.match.engine import CodeKNNEngine as JaxEngine
from qpgesture_tpu.models import vq_wav2vec as jv
from qpgesture_tpu.models import wavlm as jw
from qpgesture_tpu.models.torch_convert import convert_vqvae
from qpgesture_tpu.models.vqvae import VQVAE as JaxVQVAE
from qpgesture_tpu.motion.bvh import parse_bvh
from qpgesture_tpu.motion.pipeline import MotionPipeline
from qpgesture_tpu.serve import RawWavServer as JaxRawWavServer
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.core import constants as C
from qpgesture_tpu_torch.match import database as port_db
from qpgesture_tpu_torch.match import device_staging as ds
from qpgesture_tpu_torch.match.engine import CodeKNNEngine as PortEngine
from qpgesture_tpu_torch.models import vq_wav2vec as pv
from qpgesture_tpu_torch.models import wavlm as pw
from qpgesture_tpu_torch.models.convert import vq_wav2vec_state_dict_from_jax
from qpgesture_tpu_torch.ops import flash_attention_cuda, levenshtein_cuda
from qpgesture_tpu_torch.pipelines import audio_prep, database_builder
from qpgesture_tpu_torch.serve import RawWavServer

from fixtures import make_fixture
from test_torch_serve import TINY, _port_vqvae
from test_torch_staging import port_config, stage

sys.path.insert(0, os.path.dirname(__file__))
from test_motion import make_bvh_text  # noqa: E402

VQW2V_SMALL = ((16, 10, 5), (16, 8, 4), (16, 4, 2), (16, 4, 2), (16, 4, 2))
WAVLM_SMALL = dict(encoder_layers=2, encoder_embed_dim=32,
                   encoder_ffn_embed_dim=64, encoder_attention_heads=2,
                   conv_feature_layers=((16, 10, 5), (16, 3, 2)),
                   conv_pos=8, conv_pos_groups=2)


@pytest.mark.parametrize("mode,wavvq_mode", [
    ("wavlm_feat", "combine"), ("wavlm", "combine"),
    ("wavvq_feat", "combine"), ("wavvq_feat", "sum")])
def test_device_staging_equals_host_staging(mode, wavvq_mode):
    """Bit-equal: the integer gathers, and the lerp, whose float32 weights
    and multiply-then-add order are the host's."""
    rng = np.random.RandomState(41)
    cfg = port_config(dataclasses.replace(MATCH_PRESETS["shipped"],
                                          audio_mode=mode,
                                          wavvq_mode=wavvq_mode))
    db = port_db.stage_database(
        cfg, make_fixture(rng, n_seq=2)["bundle"],
        rng.randint(0, 512, (2, 30)).astype(np.int32),
        make_fixture(rng, n_seq=2)["signature"],
        wavlm=rng.randn(2, 199, 32).astype(np.float32),
        wavvq=rng.randint(0, 320, (2, 398, 2)).astype(np.int32))
    if mode == "wavvq_feat":
        x = rng.randint(0, C.WAVVQ_VOCAB, (2, C.WAVVQ_FRAMES, 2)
                        ).astype(np.int32)
        got = ds.stage_wavvq(cfg, db.geom, torch.from_numpy(x))
        want = port_db.stage_test_audio(cfg, db, wavvq=x)
    else:
        x = rng.randn(2, 199, 32).astype(np.float32)
        got = ds.stage_wavlm(cfg, db.geom, torch.from_numpy(x))
        want = port_db.stage_test_audio(cfg, db, wavlm=x)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    ctx = rng.randn(2, 30, 384).astype(np.float32)
    np.testing.assert_array_equal(
        ds.stage_context(db.geom, torch.from_numpy(ctx)).numpy(),
        port_db.stage_test_context(db, ctx))


def _port_vqw2v(seed=2, **over):
    torch.manual_seed(seed)
    return pv.VQWav2Vec(pv.VQWav2VecConfig(conv_layers=VQW2V_SMALL, **over),
                        device="cpu")


@pytest.mark.parametrize("depth", [1, 2])
def test_vq_wav2vec_codes_bit_equal_jax(depth):
    """Random port weights through the JAX package's converter: the codes
    (the argmax of true-float32 logits) are equal."""
    model = _port_vqw2v(weight_proj_depth=depth)
    jcfg = jv.VQWav2VecConfig(conv_layers=VQW2V_SMALL,
                              weight_proj_depth=depth)
    _, variables = jv.convert_vq_wav2vec(model.state_dict(), jcfg)
    wav = (np.random.RandomState(3).randn(2, 64000) * 0.1
           ).astype(np.float32)
    want = np.asarray(jv.VQWav2Vec(jcfg).apply(variables, jnp.asarray(wav)))
    got = model(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 398, 2) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_vq_wav2vec_from_jax_parameters_and_checkpoint(tmp_path):
    """JAX-initialised parameters through the port's converter give the JAX
    codes; a fairseq checkpoint with a flat weight_proj loads."""
    jcfg = jv.VQWav2VecConfig(weight_proj_depth=2)
    wav = (np.random.RandomState(4).randn(1, 64000) * 0.1
           ).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jv.VQWav2Vec(jcfg).init(
        jax.random.PRNGKey(1), jnp.asarray(wav)))
    pcfg = pv.VQWav2VecConfig(weight_proj_depth=2)
    sd = vq_wav2vec_state_dict_from_jax(variables, pcfg)
    want = np.asarray(jv.VQWav2Vec(jcfg).apply(variables, jnp.asarray(wav)))
    flat = {k.replace("weight_proj.0.0.", "weight_proj.0.")
             .replace("weight_proj.1.", "weight_proj.2."): v
            for k, v in sd.items()}
    path = str(tmp_path / "vq-wav2vec.pt")
    torch.save({"model": dict(flat, **{"vector_quantizer.vars":
                                       torch.zeros(1, 640, 8)})}, path)
    model = pv.load_vq_wav2vec_checkpoint(path, device="cpu")
    assert model.cfg.weight_proj_depth == 2
    np.testing.assert_array_equal(model(torch.from_numpy(wav)).numpy(), want)


def _setup(preset, seed):
    rng = np.random.RandomState(seed)
    fx = make_fixture(rng, n_seq=4, n_test=2, codebook=32)
    cfg = dataclasses.replace(MATCH_PRESETS[preset], codebook_size=32)
    jdb, _, _ = stage(jax_db, cfg, fx)
    pdb, _, _ = stage(port_db, port_config(cfg), fx)
    vq = _port_vqvae()      # l_bins 64 >= the 32 codes of the fixture
    return rng, fx, cfg, jdb, pdb, vq


@pytest.mark.parametrize("preset", ["shipped", "wavvq"])
def test_rawwav_server_matches_jax_and_host_path(preset):
    """int16 windows in: the port's RawWavServer selects the codes of the
    JAX RawWavServer (same encoder and VQ-VAE weights), and the codes of
    encoding + host staging + engine.predict in the port."""
    rng, fx, cfg, jdb, pdb, vq = _setup(preset, 53)
    if preset == "shipped":
        pcfg = pw.WavLMConfig(**WAVLM_SMALL)
        torch.manual_seed(3)
        encoder = pw.WavLM(pcfg, device="cpu")
        jenc = jw.WavLMJax(jw.WavLMJaxConfig(scan_layers=False,
                                             **WAVLM_SMALL))
        enc_vars = jw.convert_wavlm(encoder.state_dict(), jenc.cfg)
        wav = (rng.randn(2, 2000) * 2000).astype(np.int16)
    else:
        encoder = _port_vqw2v()
        jenc = jv.VQWav2Vec(jv.VQWav2VecConfig(conv_layers=VQW2V_SMALL))
        _, enc_vars = jv.convert_vq_wav2vec(encoder.state_dict(), jenc.cfg)
        wav = (rng.randn(2, 64000) * 3000).astype(np.int16)
    vq_cfg = VQVAEConfig(input_dim=135, **TINY)
    params, cb = convert_vqvae(vq.state_dict(), vq_cfg)
    jax_server = JaxRawWavServer(
        JaxEngine(cfg, jdb), JaxVQVAE(vq_cfg), params, cb,
        lambda p, w: jenc.apply(p, w), enc_vars)
    engine = PortEngine(port_config(cfg), pdb, device="cpu")
    server = RawWavServer(engine, vq, encoder)
    ctx = fx["test_context"]

    before = (flash_attention_cuda.launches, levenshtein_cuda.launches)
    codes, poses = server.serve(wav, ctx, init_code=5,
                                rng=np.random.RandomState(cfg.seed))
    assert (flash_attention_cuda.launches,
            levenshtein_cuda.launches) == before     # CPU: no kernel ran
    want_codes, want_poses = jax_server.serve(
        wav, ctx, init_code=5, rng=np.random.RandomState(cfg.seed))
    np.testing.assert_array_equal(codes, want_codes)
    assert poses.shape == (2 * 240, 135)
    np.testing.assert_allclose(poses, want_poses, rtol=0, atol=1e-4)

    enc = encoder(torch.from_numpy(wav.astype(np.float32) / 32768.0))
    key = "wavvq" if preset == "wavvq" else "wavlm"
    ta = port_db.stage_test_audio(port_config(cfg), pdb,
                                  **{key: enc.numpy()})
    tc = port_db.stage_test_context(pdb, ctx)
    host = engine.predict(ta, tc, init_code=5,
                          init_phase=np.zeros((8, 16), np.float32),
                          rng=np.random.RandomState(cfg.seed))
    np.testing.assert_array_equal(codes, host.codes)


def test_rawwav_server_rejects_mfcc_modes_and_batch():
    """MFCC modes are refused; serve_sharded outside any process group is a
    world of one and gives serve()'s codes and poses (the multi-rank cases:
    tests/test_torch_parallel.py)."""
    rng, fx, cfg, _, pdb, vq = _setup("wavvq", 59)
    server = RawWavServer(PortEngine(port_config(cfg), pdb, device="cpu"),
                          vq, _port_vqw2v())
    wav = (rng.randn(2, 64000) * 3000).astype(np.int16)
    want = server.serve(wav, fx["test_context"][:2], init_code=3,
                        rng=np.random.RandomState(cfg.seed))
    got = server.serve_sharded(None, wav, fx["test_context"][:2],
                               init_code=3,
                               rng=np.random.RandomState(cfg.seed))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    mcfg = port_config(dataclasses.replace(MATCH_PRESETS["mfcc"],
                                           codebook_size=32))
    mdb = port_db.stage_database(mcfg, fx["bundle"], fx["codes"],
                                 fx["signature"])
    with pytest.raises(ValueError, match="MFCC"):
        RawWavServer(PortEngine(mcfg, mdb, device="cpu"), vq, _port_vqw2v())


def _write_generate_inputs(tmp_path, fx, rng, preset):
    """Database files, a 4.5 s 16 kHz wav, the encoder checkpoint in its
    published layout (Microsoft's WavLM or fairseq's vq-wav2vec), a VQ-VAE
    .bin and a pipeline snapshot. Returns the generate arguments."""
    p = {k: str(tmp_path / f"{k}.npz") for k in
         ("db", "codes", "sig", "wavlm", "wavvq")}
    fx["bundle"].save(p["db"])
    from qpgesture_tpu.core.schemas import save_codes, save_wavlm, save_wavvq
    save_codes(p["codes"], fx["codes"])
    fx["signature"].save(p["sig"])
    save_wavlm(p["wavlm"], fx["wavlm"])
    save_wavvq(p["wavvq"], fx["wavvq"])
    wav_path = str(tmp_path / "speech.wav")
    audio_prep.write_wav(wav_path, rng.randn(72000) * 0.1, 16000)
    torch.manual_seed(6)
    if preset != "wavvq":
        # WavLM's own conv stack (the loaders ignore the checkpoint's), a
        # narrow 1-layer encoder whose width matches the fixture's
        # 32-dim database features
        cfg = pw.WavLMConfig(encoder_layers=1, encoder_embed_dim=32,
                             encoder_ffn_embed_dim=64,
                             encoder_attention_heads=2)
        enc = pw.WavLM(cfg, device="cpu")
        ckpt = {"cfg": {k: v for k, v in dataclasses.asdict(cfg).items()
                        if k != "conv_feature_layers"},
                "model": dict(enc.state_dict(), mask_emb=torch.zeros(32))}
        enc_args = ["--train-wavlm", p["wavlm"], "--wavlm-checkpoint"]
    else:
        enc = pv.VQWav2Vec(device="cpu")
        ckpt = {"model": enc.state_dict()}
        enc_args = ["--train-wavvq", p["wavvq"], "--wavvq-checkpoint"]
    enc_path = str(tmp_path / "encoder.pt")
    torch.save(ckpt, enc_path)
    text, _ = make_bvh_text(rng, n_frames=48, fps=120)
    pipe = MotionPipeline(          # a 6-joint skeleton: 54 channels
        target_joints=["Spine", "Spine1", "RightShoulder", "RightArm",
                       "LeftShoulder", "LeftArm"], fps=60).fit(
        parse_bvh(text))
    pipe_path = str(tmp_path / "pipeline.json")
    with open(pipe_path, "w") as f:
        f.write(pipe.to_json())
    vq_path = str(tmp_path / "vqvae.bin")
    torch.save({"model_dict": _port_vqvae(input_dim=54).state_dict()},
               vq_path)
    cfg_path = str(tmp_path / "config.yml")
    import yaml
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"VQVAE": dict(TINY, input_dim=54)}, f)
    return ["generate", "--wav", wav_path, "--train-database", p["db"],
            "--train-codebook", p["codes"], "--codebook-signature", p["sig"],
            *enc_args, enc_path, "--vqvae-checkpoint", vq_path,
            "--pipeline", pipe_path, "--config", cfg_path,
            "--preset", preset, "--prefix", "g"]


@pytest.mark.parametrize("preset", ["shipped", "wavvq", "no_text"])
def test_generate_matches_jax(tmp_path, preset):
    """wav file -> BVH through both CLIs: equal BVH headers, motion within
    1e-3 (the BVH text carries 6 decimals). Every preset but wavvq encodes
    with WavLM (no_text: WavLM cosine + phase, no text side)."""
    rng = np.random.RandomState(17)
    fx = make_fixture(rng, n_seq=4, n_test=1, codebook=64)
    args = _write_generate_inputs(tmp_path, fx, rng, preset)
    jax_cli(args + ["--out", str(tmp_path / "jax_out")])
    port_cli(args + ["--out", str(tmp_path / "port_out"), "--device", "cpu"])
    texts = []
    for d in ("jax_out", "port_out"):
        with open(tmp_path / d / "g_generated.bvh") as f:
            texts.append(f.read())
    assert texts[0].split("MOTION")[0] == texts[1].split("MOTION")[0]
    want, got = parse_bvh(texts[0]), parse_bvh(texts[1])
    assert got.values.shape == want.values.shape == (240,
                                                     len(want.channel_names))
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-3)


def test_window_and_wav_helpers_match_jax(tmp_path):
    from qpgesture_tpu.pipelines import audio_prep as jax_audio
    from qpgesture_tpu.pipelines import database_builder as jax_builder
    rng = np.random.RandomState(23)
    wav = (rng.randn(150000) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(database_builder.window_test_audio(wav),
                                  jax_builder.window_test_audio(wav))
    texts = ["hello world", "", "the quick fox"]
    np.testing.assert_array_equal(database_builder.hashed_embed_fn()(texts),
                                  jax_builder.hashed_embed_fn()(texts))
    path = str(tmp_path / "a.wav")
    audio_prep.write_wav(path, wav[:44100], 44100)
    np.testing.assert_array_equal(audio_prep.load_wav_16k(path),
                                  jax_audio.load_wav_16k(path))
