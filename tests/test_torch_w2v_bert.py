"""w2v-BERT 2.0 in the port: the encoder against the benchmark's plain
reference and against ``transformers``' ``Wav2Vec2BertModel`` with the same
weights, the Kaldi filter banks against ``SeamlessM4TFeatureExtractor``,
kernel K4's plain version against a materialised relative-key softmax, and
the encoder on the raw-wav serving path. The JAX package has no w2v-BERT,
so nothing here runs it. Small widths (hidden 64, 2 layers, 4 heads) on
4 s windows, so that T = 199 reaches both ends of the relative clamp."""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark import spec, weights
from benchmark.reference import w2v_bert as ref_w2v_bert
from qpgesture_tpu_torch.core.config import MATCH_PRESETS, VQVAEConfig
from qpgesture_tpu_torch.match import database as port_db
from qpgesture_tpu_torch.match.engine import CodeKNNEngine
from qpgesture_tpu_torch.models.vqvae import VQVAE
from qpgesture_tpu_torch.models.w2v_bert import load_w2v_bert_checkpoint
from qpgesture_tpu_torch.ops import (flash_attention_cuda, fbank as port_fbank,
                                     relkey_attention_cuda)
from qpgesture_tpu_torch.serve import (RawWavServer, StreamingPool,
                                       StreamingRawWavPool)
from qpgesture_tpu_torch.utils import profiling

from fixtures import make_fixture

os.environ.setdefault("USE_TF", "0")      # transformers without TensorFlow

SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128)
# Encoder features sit at the final LayerNorm's unit scale. Port and plain
# reference are float32 on both sides, the same operations in other
# groupings (channels-last pointwise convs, K4's q E^T before its gather):
# summation order only, ~1e-6.
ENC_ATOL = 2e-5
# The port's filter banks are float32; the extractor's are float64 rounded
# to float32. Normalised features of unit scale: float32 FFT and mel
# rounding, 2e-4 at most on these windows.
FBANK_ATOL = 2e-3


def _small_cfg():
    with open(os.path.join("benchmark", "configs",
                           "w2v-bert-2.0-j1024.json")) as f:
        return spec.merge(json.load(f), {**SMALL, "database": {"windows": 6}})


def _windows(seed, n, samples=64000, span=8192):
    rng = np.random.RandomState(seed)
    return rng.randint(-span, span, (n, samples)).astype(np.int16)


def _small_model(seed=3):
    cfg = _small_cfg()
    mod = spec.plugin("models", "w2v_bert")
    model = mod.program(cfg, "cpu")
    w = weights.draw(mod.spec(cfg), seed, 1, "cpu")
    model.load_state_dict(w, strict=True)
    return cfg, model, w


def test_w2v_bert_equals_the_plain_reference():
    cfg, model, w = _small_model()
    wav = torch.from_numpy(_windows(5, 2).astype(np.float32) / 32768.0)
    got = model(wav)
    want = ref_w2v_bert.features(w, cfg, wav)
    assert got.shape == want.shape == (2, 199, 64)
    torch.testing.assert_close(got, want, atol=ENC_ATOL, rtol=0)


def test_w2v_bert_equals_transformers(tmp_path):
    """A ``Wav2Vec2BertModel`` of random weights saved in its own layout
    loads through ``load_w2v_bert_checkpoint`` and gives its hidden states,
    from the port's filter banks exactly as from the extractor's within
    their difference."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(7)
    hcfg = transformers.Wav2Vec2BertConfig(layerdrop=0.0, **SMALL)
    hf = transformers.Wav2Vec2BertModel(hcfg).eval()
    with torch.no_grad():     # LayerNorms and embeddings off their init
        for name, p in hf.named_parameters():
            p.add_(torch.randn_like(p) * (0.1 if p.dim() == 1 else 0.02))
    hf.save_pretrained(str(tmp_path))
    model = load_w2v_bert_checkpoint(str(tmp_path), device="cpu")
    assert model.cfg.hidden_size == 64 and model.cfg.num_hidden_layers == 2
    wav = _windows(6, 2).astype(np.float32) / 32768.0
    got = model(torch.from_numpy(wav))
    with torch.no_grad():
        same_feats = hf(port_fbank.fbank(torch.from_numpy(wav))
                        ).last_hidden_state
        ext = transformers.SeamlessM4TFeatureExtractor()
        feats = ext(list(wav), sampling_rate=16000,
                    return_tensors="np")["input_features"]
        want = hf(torch.from_numpy(feats)).last_hidden_state
    # the same operations on the same features: summation order only
    torch.testing.assert_close(got, same_feats, atol=ENC_ATOL, rtol=0)
    # the filter banks' difference (FBANK_ATOL's) through two layers
    torch.testing.assert_close(got, want, atol=1e-2, rtol=0)
    cfg, _, _ = _small_model()
    torch.testing.assert_close(
        ref_w2v_bert.features(dict(hf.state_dict()), cfg,
                              torch.from_numpy(wav)), same_feats,
        atol=ENC_ATOL, rtol=0)


def _checkpoint_dir(path, w):
    """A checkpoint directory in transformers' layout at the small widths:
    config.json and pytorch_model.bin."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(SMALL, f)
    torch.save(w, os.path.join(path, "pytorch_model.bin"))
    return str(path)


def test_checkpoint_without_a_tensor_is_refused(tmp_path):
    _, _, w = _small_model()
    path = _checkpoint_dir(tmp_path / "ckpt", {
        k: v for k, v in w.items() if "ffn2.output_dense.bias" not in k})
    with pytest.raises(KeyError, match="lacks 2 w2v-BERT tensors"):
        load_w2v_bert_checkpoint(path, device="cpu")


@pytest.mark.parametrize("samples", [64000, 16000])
def test_fbank_equals_seamless_extractor(samples):
    transformers = pytest.importorskip("transformers")
    wav = _windows(samples, 3, samples).astype(np.float32) / 32768.0
    want = transformers.SeamlessM4TFeatureExtractor()(
        list(wav), sampling_rate=16000, return_tensors="np")["input_features"]
    got = port_fbank.fbank(torch.from_numpy(wav)).numpy()
    frames = ((samples - 400) // 160 + 1) // 2      # 199 and 49
    assert got.shape == want.shape == (3, frames, 160)
    np.testing.assert_allclose(got, want, atol=FBANK_ATOL, rtol=0)
    assert port_fbank.n_frames(samples) == frames


def test_fbank_bank_and_window_are_kaldis():
    transformers = pytest.importorskip("transformers")
    ext = transformers.SeamlessM4TFeatureExtractor()
    np.testing.assert_allclose(port_fbank.mel_bank(), ext.mel_filters,
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(port_fbank.povey_window(), ext.window,
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("T", [1, 9, 150])
def test_relkey_plain_equals_materialised_softmax(T):
    """K4's plain version against the attention written out term by term:
    E[clamp(key - query, -left, right) + left] for every pair, one
    table for all heads, the scale on the sum."""
    g = torch.Generator().manual_seed(T)
    B, H, hd, left, right = 2, 3, 16, 64, 8
    q, k, v = (torch.randn(B, H, T, hd, generator=g) for _ in range(3))
    emb = torch.randn(left + right + 1, hd, generator=g)
    got = relkey_attention_cuda.relkey_attention(
        q, k, v, emb, left=left, right=right, sm_scale=hd ** -0.5)
    rel = torch.empty(T, T, hd)
    for i in range(T):
        for j in range(T):
            rel[i, j] = emb[min(max(j - i, -left), right) + left]
    s = (torch.einsum("bhid,bhjd->bhij", q, k)
         + torch.einsum("bhid,ijd->bhij", q, rel)) / math.sqrt(hd)
    want = torch.softmax(s, -1) @ v
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


def test_relkey_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 2, 5, 16)
    with pytest.raises(ValueError, match="left \\+ right \\+ 1"):
        relkey_attention_cuda.relkey_attention(
            q, q, q, torch.zeros(72, 16), left=64, right=8, sm_scale=0.25)
    with pytest.raises(TypeError, match="float32"):
        relkey_attention_cuda.relkey_attention(
            q.double(), q.double(), q.double(), torch.zeros(73, 16).double(),
            left=64, right=8, sm_scale=0.25)


def test_encoder_spans_and_counters_on_the_cpu():
    """fbank and conformer spans with their frames and layers; K4's
    counter and ``relkey_kernel`` untouched on the CPU."""
    _, model, _ = _small_model()
    wav = torch.from_numpy(_windows(8, 1).astype(np.float32) / 32768.0)
    before = relkey_attention_cuda.launches
    with profiling.recording() as prof:
        model(wav)
    recs = {r["name"]: r for r in prof.take()}
    assert recs["fbank"]["counters"] == {"frames": 199}
    assert recs["conformer"]["counters"] == {"layers": 2}
    assert relkey_attention_cuda.launches == before


def _server(seed):
    rng = np.random.RandomState(seed)
    fx = make_fixture(rng, n_seq=4, n_test=2, codebook=32)
    cfg = dataclasses.replace(MATCH_PRESETS["shipped"], codebook_size=32)
    feats = rng.randn(4, 199, 64).astype(np.float32)
    db = port_db.stage_database(cfg, fx["bundle"], fx["codes"],
                                fx["signature"], wavlm=feats)
    torch.manual_seed(seed)
    vq = VQVAE(VQVAEConfig(input_dim=135, width=32, depth=1, l_bins=64,
                           emb_width=32), device="cpu")
    _, encoder, _ = _small_model()
    engine = CodeKNNEngine(cfg, db, device="cpu")
    return cfg, db, engine, RawWavServer(engine, vq, encoder), encoder, fx


def test_rawwav_server_and_pool_with_w2v_bert_match_host_staging():
    """int16 windows through RawWavServer and StreamingRawWavPool with a
    w2v-BERT encoder select the codes of encoding, staging on the host and
    engine.predict; no kernel counter moves on the CPU."""
    cfg, db, engine, server, encoder, fx = _server(61)
    wav = _windows(62, 2)
    ctx = fx["test_context"][:2]
    counts = (flash_attention_cuda.launches, relkey_attention_cuda.launches)
    codes, poses = server.serve(wav, ctx, init_code=5,
                                rng=np.random.RandomState(cfg.seed))
    enc = encoder(torch.from_numpy(wav.astype(np.float32) / 32768.0))
    host = engine.predict(port_db.stage_test_audio(cfg, db,
                                                   wavlm=enc.numpy()),
                          port_db.stage_test_context(db, ctx), init_code=5,
                          init_phase=np.zeros((8, 16), np.float32),
                          rng=np.random.RandomState(cfg.seed))
    np.testing.assert_array_equal(codes, host.codes)
    assert poses.shape == (2 * 240, 135)

    init_codes = np.array([3, 7])
    init_phases = np.random.RandomState(63).rand(2, 8, 16).astype(np.float32)
    rngs = lambda: [np.random.RandomState(i) for i in range(2)]  # noqa: E731
    pool = StreamingRawWavPool(server, 2, init_codes=init_codes,
                               init_phases=init_phases, rngs=rngs())
    staged = StreamingPool(engine, 2, init_codes=init_codes,
                           init_phases=init_phases, rngs=rngs())
    for _ in range(2):       # the second tick starts from carried state
        np.testing.assert_array_equal(
            pool.tick(wav, ctx),
            staged.tick(port_db.stage_test_audio(cfg, db, wavlm=enc.numpy()),
                        port_db.stage_test_context(db, ctx)))
    assert (flash_attention_cuda.launches,
            relkey_attention_cuda.launches) == counts


def test_cli_matching_encodes_with_the_flag_given(tmp_path):
    """``generate``'s matching takes w2v-BERT through
    --w2v-bert-checkpoint in place of WavLM: the codes of engine.predict on
    the staged features of the checkpoint's encoder; the wavlm presets
    refuse both flags and neither."""
    import argparse
    from qpgesture_tpu_torch import cli
    from qpgesture_tpu_torch.core.schemas import save_codes, save_wavlm
    from qpgesture_tpu_torch.pipelines import database_builder
    rng = np.random.RandomState(71)
    fx = make_fixture(rng, n_seq=3, n_test=1, codebook=512)
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("db", "codes", "sig",
                                                    "feats")}
    fx["bundle"].save(paths["db"])
    save_codes(paths["codes"], fx["codes"])
    fx["signature"].save(paths["sig"])
    save_wavlm(paths["feats"], rng.randn(3, 199, 64).astype(np.float32))
    _, encoder, w = _small_model()
    ckpt = _checkpoint_dir(tmp_path / "w2v", w)
    args = argparse.Namespace(
        train_database=paths["db"], train_codebook=paths["codes"],
        codebook_signature=paths["sig"], train_wavlm=paths["feats"],
        train_wavvq=None, preset="shipped",
        wavvq_checkpoint=None, wavlm_checkpoint=None,
        w2v_bert_checkpoint=ckpt, device="cpu")
    wav = (rng.randn(72000) * 0.1).astype(np.float32)
    codes, _ = cli._match_codes(args, wav)
    windows = database_builder.window_test_audio(wav)
    cfg = dataclasses.replace(MATCH_PRESETS["shipped"], codebook_size=512)
    db = port_db.stage_database(
        cfg, fx["bundle"], fx["codes"], fx["signature"],
        wavlm=np.load(paths["feats"])["wavlm"])
    ctx = np.tile(database_builder.hashed_embed_fn()([""] * 30)[None],
                  (windows.shape[0], 1, 1)).astype(np.float32)
    want = CodeKNNEngine(cfg, db, device="cpu").predict(
        port_db.stage_test_audio(
            cfg, db, wavlm=database_builder.extract_wavlm(encoder, windows)),
        port_db.stage_test_context(db, ctx)).codes
    np.testing.assert_array_equal(codes, want)
    for both in ({"wavlm_checkpoint": ckpt}, {"w2v_bert_checkpoint": None}):
        with pytest.raises(SystemExit, match="exactly one of"):
            cli._match_codes(argparse.Namespace(**{**vars(args), **both}),
                             wav)
