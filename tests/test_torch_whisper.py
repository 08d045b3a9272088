"""Whisper-large-v3's encoder in the port: the encoder against the
benchmark's plain reference and against ``transformers``' ``WhisperEncoder``
with the same weights, the log-mel against ``WhisperFeatureExtractor``, K2's
plain version without a bias against a materialised softmax, and the
encoder on the raw-wav serving path, where each clip is one 30 s utterance.
The JAX package has no Whisper, so nothing here runs it. Small widths
(d_model 64, 2 layers, 4 heads) at the published 128 mel bins and 1500
positions, on 4 s windows."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import spec, weights
from benchmark.reference import whisper as ref_whisper
from qpgesture_tpu_torch.core.config import MATCH_PRESETS, VQVAEConfig
from qpgesture_tpu_torch.match import database as port_db
from qpgesture_tpu_torch.match.engine import CodeKNNEngine
from qpgesture_tpu_torch.models.vqvae import VQVAE
from qpgesture_tpu_torch.models.whisper import (WhisperConfig,
                                                WhisperEncoder,
                                                load_whisper_checkpoint)
from qpgesture_tpu_torch.ops import flash_attention_cuda, logmel as port_mel
from qpgesture_tpu_torch.serve import (RawWavServer, StreamingPool,
                                       StreamingRawWavPool,
                                       StreamingRawWavSession)
from qpgesture_tpu_torch.utils import profiling

from fixtures import make_fixture

os.environ.setdefault("USE_TF", "0")      # transformers without TensorFlow

SMALL = dict(d_model=64, encoder_layers=2, encoder_attention_heads=4,
             encoder_ffn_dim=128)
# Encoder features sit at the final LayerNorm's unit scale. Port and plain
# reference are float32 on both sides, the same operations in other
# groupings (K2's online softmax over key tiles against a materialised
# softmax over row blocks): summation order only, ~1e-6.
ENC_ATOL = 2e-5
# The port's log-mel and the extractor's torch path are the same float32
# operations; they differ by the mel product's summation order, an ulp or
# two of features of unit scale.
MEL_ATOL = 1e-5


def _small_cfg():
    with open(os.path.join("benchmark", "configs",
                           "whisper-large-v3-j1024.json")) as f:
        return spec.merge(json.load(f), {**SMALL, "database": {"windows": 6}})


def _windows(seed, n, samples=64000, span=8192):
    rng = np.random.RandomState(seed)
    return rng.randint(-span, span, (n, samples)).astype(np.int16)


def _float(wav):
    return torch.from_numpy(wav.astype(np.float32) / 32768.0)


def _small_model(seed=3):
    cfg = _small_cfg()
    mod = spec.plugin("models", "whisper")
    model = mod.program(cfg, "cpu")
    w = weights.draw(mod.spec(cfg), seed, 1, "cpu")
    model.load_state_dict(w, strict=True)
    return cfg, model, w


@pytest.mark.parametrize("W", [1, 6, 7])
def test_whisper_equals_the_plain_reference(W):
    """A clip of W windows as one utterance: the port's (W, 200, D) against
    the reference's, the 30 s padding computed on both sides."""
    cfg, model, w = _small_model()
    wav = _float(_windows(5 + W, W))
    got = model(wav, clips=1)
    want = ref_whisper.features(w, cfg, wav)
    assert got.shape == want.shape == (W, 200, 64)
    torch.testing.assert_close(got, want, atol=ENC_ATOL, rtol=0)


def test_clips_are_utterances_of_their_own():
    """C clips in one call equal C calls of one clip each; a window alone
    (clips None) is another utterance than the same window in a clip."""
    _, model, _ = _small_model()
    wav = _float(_windows(9, 6))
    both = model(wav, clips=2)
    torch.testing.assert_close(both, torch.cat([model(wav[:3], clips=1),
                                                model(wav[3:], clips=1)]),
                               atol=ENC_ATOL, rtol=0)
    alone = model(wav)
    torch.testing.assert_close(alone[:1], model(wav[:1], clips=1),
                               atol=ENC_ATOL, rtol=0)
    assert float((alone[1] - both[1]).abs().max()) > 1e-2


def _hf_small(transformers, seed=7):
    torch.manual_seed(seed)
    hcfg = transformers.WhisperConfig(
        num_mel_bins=128, max_source_positions=1500, decoder_layers=1,
        decoder_attention_heads=4, decoder_ffn_dim=128, **SMALL)
    hf = transformers.WhisperModel(hcfg).eval()
    with torch.no_grad():     # LayerNorms and biases off their init
        for name, p in hf.named_parameters():
            p.add_(torch.randn_like(p) * (0.1 if p.dim() == 1 else 0.02))
    return hf


def test_whisper_equals_transformers(tmp_path):
    """A ``WhisperModel`` of random weights saved in its own layout loads
    through ``load_whisper_checkpoint`` (its ``encoder.*`` tensors) and gives
    its encoder's hidden states, cut to the clip's windows, from the port's
    log-mel as from the extractor's."""
    transformers = pytest.importorskip("transformers")
    hf = _hf_small(transformers)
    hf.save_pretrained(str(tmp_path))
    model = load_whisper_checkpoint(str(tmp_path), device="cpu")
    assert model.cfg.d_model == 64 and model.cfg.encoder_layers == 2
    wav = _windows(6, 6).astype(np.float32) / 32768.0
    got = model(torch.from_numpy(wav), clips=1)
    ext = transformers.WhisperFeatureExtractor(feature_size=128)
    feats = ext([wav.reshape(-1)], sampling_rate=16000,
                return_tensors="np")["input_features"]
    with torch.no_grad():
        want = hf.encoder(torch.from_numpy(feats)).last_hidden_state
    assert want.shape == (1, 1500, 64)
    torch.testing.assert_close(got, want[0, :1200].reshape(6, 200, 64),
                               atol=ENC_ATOL, rtol=0)
    cfg, _, _ = _small_model()
    enc_w = {k[len("encoder."):]: v for k, v in hf.state_dict().items()
             if k.startswith("encoder.")}
    torch.testing.assert_close(
        ref_whisper.features(enc_w, cfg, torch.from_numpy(wav)), got,
        atol=ENC_ATOL, rtol=0)


def test_generation_checkpoint_loads_and_a_missing_tensor_is_refused(
        tmp_path):
    """``model.encoder.*`` (WhisperForConditionalGeneration's state dict)
    loads as ``encoder.*`` does; a checkpoint that lacks one of the
    encoder's tensors is refused by name."""
    transformers = pytest.importorskip("transformers")
    hf = _hf_small(transformers)
    sd = {f"model.{k}": v for k, v in hf.state_dict().items()}

    def save(name, tensors):
        os.makedirs(tmp_path / name)
        hf.config.to_json_file(str(tmp_path / name / "config.json"))
        torch.save(tensors, tmp_path / name / "pytorch_model.bin")
        return str(tmp_path / name)

    model = load_whisper_checkpoint(save("full", sd), device="cpu")
    for name, p in model.state_dict().items():
        assert torch.equal(p, sd[f"model.encoder.{name}"])
    del sd["model.encoder.layers.1.fc2.bias"]
    with pytest.raises(KeyError, match="lacks 1 Whisper encoder tensors"):
        load_whisper_checkpoint(save("short", sd), device="cpu")


@pytest.mark.parametrize("seconds", [4.0, 11.3, 24.0, 30.0])
def test_logmel_equals_whisper_feature_extractor(seconds):
    transformers = pytest.importorskip("transformers")
    n = int(seconds * 16000)
    wav = _windows(n, 2, n).astype(np.float32) / 32768.0
    want = transformers.WhisperFeatureExtractor(feature_size=128)(
        list(wav), sampling_rate=16000, return_tensors="np")["input_features"]
    got = port_mel.logmel(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 128, 3000)
    np.testing.assert_allclose(got, want, atol=MEL_ATOL, rtol=0)


def test_mel_bank_is_slaneys():
    """The port's bank, the extractor's and the reference's own (librosa's
    formulation) agree to float64 rounding."""
    transformers = pytest.importorskip("transformers")
    ext = transformers.WhisperFeatureExtractor(feature_size=128)
    np.testing.assert_allclose(port_mel.mel_bank(), ext.mel_filters,
                               atol=1e-12, rtol=0)
    fe = _small_cfg()["feature_extractor"]
    np.testing.assert_allclose(ref_whisper.mel_weights(fe).numpy().T,
                               ext.mel_filters, atol=1e-12, rtol=0)


def test_logmel_refuses_more_than_30_s():
    with pytest.raises(ValueError, match="30 s input"):
        port_mel.logmel(torch.zeros(1, 480001))


@pytest.mark.parametrize("T", [1, 37, 300])
def test_k2_plain_without_bias_equals_materialised_softmax(T):
    """K2's plain version with ``bias=None``: softmax(q k^T scale) v; a
    gate without a bias is refused."""
    g = torch.Generator().manual_seed(T)
    q, k, v = (torch.randn(2, 3, T, 16, generator=g) for _ in range(3))
    got = flash_attention_cuda.gated_flash_attention(q, k, v, None,
                                                     sm_scale=0.25)
    want = torch.softmax(q @ k.transpose(-1, -2) * 0.25, -1) @ v
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    with pytest.raises(ValueError, match="nothing to gate"):
        flash_attention_cuda.gated_flash_attention(
            q, k, v, None, torch.ones(2, 3, T))


def test_encoder_spans_and_counters_on_the_cpu():
    """logmel and whisper spans with their counters; no K2 launch and no
    ``attn_kernel`` on the CPU."""
    _, model, _ = _small_model()
    wav = _float(_windows(8, 4))
    before = flash_attention_cuda.launches
    with profiling.recording() as prof:
        model(wav, clips=2)
    recs = {r["name"]: r for r in prof.take()}
    assert recs["logmel"]["counters"] == {"mel_frames": 3000}
    assert recs["whisper"]["counters"] == {"layers": 2, "utterances": 2}
    assert flash_attention_cuda.launches == before


def _server(seed):
    rng = np.random.RandomState(seed)
    fx = make_fixture(rng, n_seq=4, n_test=2, codebook=32)
    cfg = dataclasses.replace(MATCH_PRESETS["shipped"], codebook_size=32)
    feats = rng.randn(4, 200, 64).astype(np.float32)
    db = port_db.stage_database(cfg, fx["bundle"], fx["codes"],
                                fx["signature"], wavlm=feats)
    torch.manual_seed(seed)
    vq = VQVAE(VQVAEConfig(input_dim=135, width=32, depth=1, l_bins=64,
                           emb_width=32), device="cpu")
    _, encoder, _ = _small_model()
    engine = CodeKNNEngine(cfg, db, device="cpu")
    return cfg, db, engine, RawWavServer(engine, vq, encoder), encoder, fx


def _host_codes(cfg, db, engine, feats, ctx, init_code, init_phase=None):
    return engine.predict(
        port_db.stage_test_audio(cfg, db, wavlm=feats.numpy()),
        port_db.stage_test_context(db, ctx), init_code=init_code,
        init_phase=np.zeros((8, 16), np.float32) if init_phase is None
        else init_phase, rng=np.random.RandomState(cfg.seed)).codes


def test_serve_equals_encoding_the_clip_and_staging_on_the_host():
    """int16 windows through RawWavServer.serve with a Whisper encoder
    select the codes of encoding the clip as one utterance, staging on the
    host and engine.predict; no kernel counter moves on the CPU."""
    cfg, db, engine, server, encoder, _ = _server(61)
    assert server.utterances
    wav = _windows(62, 3)
    ctx = np.random.RandomState(63).randn(3, 30, 384).astype(np.float32)
    before = flash_attention_cuda.launches
    codes, poses = server.serve(wav, ctx, init_code=5,
                                rng=np.random.RandomState(cfg.seed))
    want = _host_codes(cfg, db, engine, encoder(_float(wav), clips=1), ctx,
                       5)
    np.testing.assert_array_equal(codes, want)
    assert poses.shape == (3 * 240, 135)
    assert flash_attention_cuda.launches == before


def test_serve_batch_equals_serve_per_clip():
    cfg, _, _, server, _, _ = _server(64)
    C, W = 2, 3
    wav = _windows(65, C * W).reshape(C, W, -1)
    ctx = np.random.RandomState(66).randn(C, W, 30, 384).astype(np.float32)
    init_codes = np.array([4, 9])
    init_phases = np.random.RandomState(67).rand(C, 8, 16).astype(
        np.float32)
    codes, poses = server.serve_batch(wav, ctx, init_codes=init_codes,
                                      init_phases=init_phases)
    for c in range(C):
        solo, solo_poses = server.serve(wav[c], ctx[c],
                                        init_code=int(init_codes[c]),
                                        init_phase=init_phases[c])
        np.testing.assert_array_equal(codes[c], solo)
        np.testing.assert_allclose(poses[c], solo_poses, atol=1e-5, rtol=0)


def test_streams_encode_each_window_as_its_own_utterance():
    """StreamingRawWavPool and StreamingRawWavSession give each stream's
    window an utterance of its own: the codes of the staged pool on the
    windows' own features."""
    cfg, db, engine, server, encoder, _ = _server(68)
    wav = _windows(69, 2)
    ctx = np.random.RandomState(70).randn(2, 30, 384).astype(np.float32)
    feats = encoder(_float(wav))
    init_codes = np.array([3, 7])
    init_phases = np.random.RandomState(71).rand(2, 8, 16).astype(np.float32)
    rngs = lambda: [np.random.RandomState(i) for i in range(2)]  # noqa: E731
    pool = StreamingRawWavPool(server, 2, init_codes=init_codes,
                               init_phases=init_phases, rngs=rngs())
    staged = StreamingPool(engine, 2, init_codes=init_codes,
                           init_phases=init_phases, rngs=rngs())
    session = StreamingRawWavSession(server, init_code=3,
                                     init_phase=init_phases[0],
                                     rng=np.random.RandomState(0))
    for _ in range(2):       # the second tick starts from carried state
        want = staged.tick(port_db.stage_test_audio(cfg, db,
                                                    wavlm=feats.numpy()),
                           port_db.stage_test_context(db, ctx))
        np.testing.assert_array_equal(pool.tick(wav, ctx), want)
        np.testing.assert_array_equal(session.push_wav(wav[0], ctx[0]),
                                      want[0])


def test_a_clip_past_30_s_is_refused():
    _, _, _, server, encoder, _ = _server(72)
    wav = _windows(73, 8)
    ctx = np.zeros((8, 30, 384), np.float32)
    with pytest.raises(ValueError, match="30 s context: at most 7"):
        server.serve(wav, ctx)
    with pytest.raises(ValueError, match="30 s context"):
        server.serve_batch(wav.reshape(1, 8, -1), ctx.reshape(1, 8, 30, 384))
    with pytest.raises(ValueError, match="do not split into 3 clips"):
        encoder(_float(wav), clips=3)


def test_cli_matching_encodes_with_the_whisper_flag(tmp_path):
    """``generate``'s matching takes Whisper through --whisper-checkpoint
    (a saved ``WhisperModel``) in place of WavLM: the codes of
    engine.predict on the staged features of runs of up to 7 windows, each
    one utterance; the wavlm presets refuse two flags and none."""
    import argparse
    transformers = pytest.importorskip("transformers")
    from qpgesture_tpu_torch import cli
    from qpgesture_tpu_torch.core.schemas import save_codes, save_wavlm
    from qpgesture_tpu_torch.pipelines import database_builder
    rng = np.random.RandomState(74)
    fx = make_fixture(rng, n_seq=3, n_test=1, codebook=512)
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("db", "codes", "sig",
                                                    "feats")}
    fx["bundle"].save(paths["db"])
    save_codes(paths["codes"], fx["codes"])
    fx["signature"].save(paths["sig"])
    save_wavlm(paths["feats"], rng.randn(3, 200, 64).astype(np.float32))
    ckpt = str(tmp_path / "whisper")
    _hf_small(transformers).save_pretrained(ckpt)
    args = argparse.Namespace(
        train_database=paths["db"], train_codebook=paths["codes"],
        codebook_signature=paths["sig"], train_wavlm=paths["feats"],
        train_wavvq=None, preset="shipped", wavvq_checkpoint=None,
        wavlm_checkpoint=None, w2v_bert_checkpoint=None,
        whisper_checkpoint=ckpt, device="cpu")
    wav = (rng.randn(16000 * 33) * 0.1).astype(np.float32)    # 8 windows
    codes, _ = cli._match_codes(args, wav)
    windows = database_builder.window_test_audio(wav)
    assert windows.shape[0] == 8
    encoder = load_whisper_checkpoint(ckpt, device="cpu")
    feats = database_builder.extract_utterances(encoder, windows)
    with torch.no_grad():
        first = encoder(torch.from_numpy(windows[:7]), clips=1)
    np.testing.assert_array_equal(feats[:7], first.numpy())
    cfg = dataclasses.replace(MATCH_PRESETS["shipped"], codebook_size=512)
    db = port_db.stage_database(
        cfg, fx["bundle"], fx["codes"], fx["signature"],
        wavlm=np.load(paths["feats"])["wavlm"])
    ctx = np.tile(database_builder.hashed_embed_fn()([""] * 30)[None],
                  (windows.shape[0], 1, 1)).astype(np.float32)
    want = CodeKNNEngine(cfg, db, device="cpu").predict(
        port_db.stage_test_audio(cfg, db, wavlm=feats),
        port_db.stage_test_context(db, ctx)).codes
    np.testing.assert_array_equal(codes, want)
    for given in ({"wavlm_checkpoint": ckpt}, {"whisper_checkpoint": None}):
        with pytest.raises(SystemExit, match="exactly one of"):
            cli._match_codes(argparse.Namespace(**{**vars(args), **given}),
                             wav)


def test_build_db_encodes_each_recordings_runs_as_utterances(tmp_path):
    """``build-db --whisper-checkpoint`` encodes each recording's
    consecutive windows as ``generate`` encodes a query's: in runs of up to
    7, each one utterance, and never across two recordings (two 9 s train
    recordings of 2 windows: two utterances of 2, not one of 4); runs of 7
    split the same way in ``extract_utterances``."""
    import wave
    transformers = pytest.importorskip("transformers")
    from qpgesture_tpu_torch import cli
    from qpgesture_tpu_torch.examples.fixtures import make_beat_like_bvh
    from qpgesture_tpu_torch.pipelines import database_builder
    rng = np.random.RandomState(75)
    names = ("1_spk_0_1_8", "1_spk_0_9_16")
    for d in ("bvh", "wav"):
        os.makedirs(tmp_path / d)
    wavs = {}
    for name in names:
        with open(tmp_path / "bvh" / f"{name}.bvh", "w") as f:
            f.write(make_beat_like_bvh(rng, 9 * 120))
        wavs[name] = _windows(rng.randint(1 << 30), 1, 9 * 16000)[0]
        with wave.open(str(tmp_path / "wav" / f"{name}.wav"), "w") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(wavs[name].tobytes())
    ckpt = str(tmp_path / "whisper")
    _hf_small(transformers).save_pretrained(ckpt)
    cli.main(["build-db", "--bvh-dir", str(tmp_path / "bvh"), "--wav-dir",
              str(tmp_path / "wav"), "--prefix", "spk", "--out",
              str(tmp_path / "out"), "--whisper-checkpoint", ckpt,
              "--device", "cpu"])
    got = np.load(tmp_path / "out" / "spk_train_240_Whisper.npz")["wavlm"]
    encoder = load_whisper_checkpoint(ckpt, device="cpu")
    per_rec = [_float(database_builder.window_test_audio(
        wavs[n].astype(np.float32))) for n in names]
    with torch.no_grad():
        want = np.concatenate([encoder(x, clips=1).numpy() for x in per_rec])
        joined = encoder(torch.cat(per_rec), clips=1).numpy()
    assert got.shape == want.shape == (4, 200, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ENC_ATOL)
    assert np.abs(got - joined).max() > 1e-2
    windows = _float(_windows(76, 9)).numpy()
    feats = database_builder.extract_utterances(
        encoder, windows, ["a"] * 8 + ["b"])
    with torch.no_grad():
        runs = [encoder(torch.from_numpy(windows[a:b]), clips=1).numpy()
                for a, b in ((0, 7), (7, 8), (8, 9))]
    np.testing.assert_array_equal(feats, np.concatenate(runs))


def test_sinusoids_are_whispers():
    transformers = pytest.importorskip("transformers")
    from transformers.models.whisper.modeling_whisper import sinusoids
    from qpgesture_tpu_torch.models import whisper
    torch.testing.assert_close(whisper.sinusoids(1500, 64),
                               sinusoids(1500, 64), atol=0, rtol=0)
    model = WhisperEncoder(WhisperConfig(**SMALL), device="cpu")
    torch.testing.assert_close(model.embed_positions.weight.detach(),
                               sinusoids(1500, 64), atol=0, rtol=0)
