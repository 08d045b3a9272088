"""Tests that need a CUDA device: the port's kernels against their plain
versions on the card, and the engine on the card against the engine on the
CPU. They skip on machines without a GPU. This file imports no JAX, so it
also runs where only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from qpgesture_tpu_torch.core.config import MATCH_PRESETS
from qpgesture_tpu_torch.match.database import (stage_database,
                                                stage_test_audio,
                                                stage_test_context)
from qpgesture_tpu_torch.match import engine as eng
from qpgesture_tpu_torch.match.engine import CodeKNNEngine
from qpgesture_tpu_torch.ops import (flash_attention_cuda, fusion_scan_cuda,
                                     groupnorm_cuda, levenshtein_cuda,
                                     posconv_cuda, relkey_attention_cuda,
                                     segmin_cuda)
from qpgesture_tpu_torch.utils import profiling

import scan_cases
import test_torch_segmin as segmin_cases
from fixtures import make_fixture

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("Q,N,vocab", [(48, 26624, 102400),
                                       (48, 26624 + 37, 102400),
                                       (7, 1000, 4)])
def test_levenshtein_kernel_matches_plain(cuda, Q, N, vocab):
    rng = np.random.RandomState(N)
    a = torch.from_numpy(rng.randint(0, vocab, (Q, 11)).astype(np.int32))
    b = torch.from_numpy(rng.randint(0, vocab, (N, 11)).astype(np.int32))
    b[3] = a[0]
    a_d, b_d = a.to(cuda), b.to(cuda)
    before = levenshtein_cuda.launches
    got = levenshtein_cuda.levenshtein_matrix(a_d, b_d)
    torch.cuda.synchronize()
    assert levenshtein_cuda.launches == before + 1
    assert torch.equal(got, levenshtein_cuda.levenshtein_matrix_plain(a_d,
                                                                      b_d))
    assert torch.equal(got.cpu(), levenshtein_cuda.levenshtein_matrix(a, b))


def test_levenshtein_kernel_rejects_unbuilt_length(cuda):
    a = torch.zeros((2, 10), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="no kernel instantiation"):
        levenshtein_cuda.levenshtein_matrix(a, a)


def _attention_inputs(B, H, T, hd, gated, seed=0):
    rng = np.random.RandomState(seed)
    x = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in
         ((B, H, T, hd), (B, H, T, hd), (B, H, T, hd), (H, T, T), (B, H, T))]
    x[4] = 1.0 + torch.sigmoid(x[4]) if gated else None
    return x


# (B, H, T, hd, gated, kernel dtype, tolerance): float32 rows differ from the
# plain version by summation order only; bfloat16 rows also by where p is
# rounded (per key tile in the kernel, per row in the plain version), one
# bfloat16 rounding of weights that sum to 1.
@pytest.mark.parametrize("B,H,T,hd,gated,dtype,atol", [
    (6, 16, 199, 64, True, torch.float32, 1e-5),
    (6, 16, 199, 64, False, torch.float32, 1e-5),
    (6, 16, 199, 64, True, torch.bfloat16, 2e-2),
    (6, 16, 37, 64, True, torch.float32, 1e-5),
    (1, 16, 1200, 64, True, torch.float32, 1e-5),
    (2, 4, 159, 16, True, torch.float32, 1e-5),
    (2, 2, 100, 32, False, torch.bfloat16, 2e-2),
    (2, 4, 1, 64, True, torch.bfloat16, 2e-2),
    (2, 4, 33, 64, False, torch.bfloat16, 2e-2),
    (2, 4, 65, 16, True, torch.bfloat16, 2e-2),
    (1, 16, 1200, 64, True, torch.bfloat16, 2e-2),
])
def test_flash_attention_kernel_matches_plain(cuda, B, H, T, hd, gated,
                                              dtype, atol):
    q, k, v, bias, gate = (None if x is None else x.to(cuda) for x in
                           _attention_inputs(B, H, T, hd, gated, seed=T))
    before = flash_attention_cuda.launches
    got = flash_attention_cuda.gated_flash_attention(
        q, k, v, bias, gate, sm_scale=hd ** -0.5, kernel_dtype=dtype)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.shape == (B, H, T, hd) and got.dtype == torch.float32
    want = flash_attention_cuda.gated_attention_plain(
        q, k, v, bias, gate, sm_scale=hd ** -0.5, kernel_dtype=dtype)
    assert float((got - want).abs().max()) <= atol


def test_flash_attention_kernel_takes_strided_views(cuda):
    """WavLM hands the kernel (B, T, H, hd) projections seen as (B, H, T,
    hd): strided views give the contiguous inputs' result exactly."""
    q, k, v, bias, gate = (x.to(cuda) for x in
                           _attention_inputs(2, 4, 50, 64, True))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    a = flash_attention_cuda.gated_flash_attention(q, k, v, bias, gate)
    b = flash_attention_cuda.gated_flash_attention(*views, bias, gate)
    assert torch.equal(a, b)


# K2 bias-free (Whisper's plain attention) against its plain version:
# float32 on both sides, summation order only. Whisper's shape (one
# utterance, 20 heads, T = 1500), and T at the edges of the 32-key tiles,
# the 16-row warps and the 128-row query blocks; (B, T, H, hd) projections
# seen as (B, H, T, hd), as the encoder hands them.
@pytest.mark.parametrize("B,H,T,hd", [
    (1, 20, 1500, 64), (2, 3, 1, 64), (2, 3, 15, 64), (2, 3, 17, 64),
    (2, 3, 31, 64), (2, 3, 32, 64), (2, 3, 33, 64), (1, 4, 127, 64),
    (1, 4, 128, 64), (1, 4, 129, 64), (1, 20, 1408, 64), (2, 2, 200, 16),
    (2, 2, 97, 32)])
def test_nobias_flash_attention_kernel_matches_plain(cuda, B, H, T, hd):
    g = torch.Generator(device=cuda).manual_seed(T)
    q, k, v = torch.randn(3, B, T, H, hd, generator=g,
                          device=cuda).transpose(2, 3)
    before = (flash_attention_cuda.launches,
              flash_attention_cuda.nobias_launches)
    got = flash_attention_cuda.gated_flash_attention(q, k, v, None,
                                                     sm_scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches,
            flash_attention_cuda.nobias_launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert got.shape == (B, H, T, hd) and got.dtype == torch.float32
    want = flash_attention_cuda.gated_attention_plain(q, k, v, None,
                                                      sm_scale=hd ** -0.5)
    assert float((got - want).abs().max()) <= 1e-5


def test_nobias_flash_attention_refuses_bfloat16_on_card(cuda):
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="float32 only"):
        flash_attention_cuda.gated_flash_attention(
            q, q, q, None, kernel_dtype=torch.bfloat16)


def test_whisper_on_card_launches_nobias_k2_every_layer(cuda):
    """Whisper-large-v3's encoder at its published widths runs K2's
    bias-free kernel once a layer (32 launches a clip), never the gated
    one; a 2-layer one of width 64 (head width 16) gives the CPU port's
    features (float32 on both sides, summation order only, features of
    unit scale). WavLM still launches the gated kernel."""
    from qpgesture_tpu_torch.models.wavlm import WavLM, WavLMConfig
    from qpgesture_tpu_torch.models.whisper import (WhisperConfig,
                                                    WhisperEncoder)
    torch.manual_seed(0)
    wav = torch.randint(-8192, 8192, (6, 64000)).float() / 32768.0
    model = WhisperEncoder(device=cuda)
    before = (flash_attention_cuda.launches,
              flash_attention_cuda.nobias_launches)
    out = model(wav.to(cuda), clips=1)
    torch.cuda.synchronize()
    assert (flash_attention_cuda.launches,
            flash_attention_cuda.nobias_launches) == (before[0] + 32,
                                                      before[1] + 32)
    assert out.shape == (6, 200, 1280) and bool(torch.isfinite(out).all())
    del model, out
    small = WhisperConfig(d_model=64, encoder_layers=2,
                          encoder_attention_heads=4, encoder_ffn_dim=128)
    cpu = WhisperEncoder(small, device="cpu")
    card = WhisperEncoder(small, device=cuda)
    card.load_state_dict(cpu.state_dict())
    torch.testing.assert_close(card(wav.to(cuda), clips=2).cpu(),
                               cpu(wav, clips=2), atol=1e-4, rtol=0)
    wavlm = WavLM(WavLMConfig(encoder_layers=2), device=cuda)
    before = (flash_attention_cuda.launches,
              flash_attention_cuda.nobias_launches)
    wavlm(wav[:2].to(cuda))
    assert (flash_attention_cuda.launches,
            flash_attention_cuda.nobias_launches) == (before[0] + 2,
                                                      before[1])


def test_whisper_serves_and_matches_through_the_cli_on_card(cuda, tmp_path):
    """Whisper-large-v3's encoder at its published widths (random weights)
    on the raw-wav path: ``serve`` of a 6-window clip and ``serve_batch`` of
    two select the codes of host staging on the encoder's own features for
    that clip layout; ``generate``'s matching through --whisper-checkpoint
    (a state-dict directory) gives engine.predict's codes on the features
    of runs of up to 7 windows, each one utterance."""
    import argparse
    import json
    from qpgesture_tpu_torch import cli
    from qpgesture_tpu_torch.core.schemas import save_codes, save_wavlm
    from qpgesture_tpu_torch.core.config import VQVAEConfig
    from qpgesture_tpu_torch.models.vqvae import VQVAE
    from qpgesture_tpu_torch.models.whisper import (WhisperEncoder,
                                                    load_whisper_checkpoint)
    from qpgesture_tpu_torch.pipelines import database_builder
    from qpgesture_tpu_torch.serve import RawWavServer
    rng = np.random.RandomState(81)
    fx = make_fixture(rng, n_seq=3, n_test=1, codebook=512)
    feats = rng.randn(3, 200, 1280).astype(np.float32)
    cfg = dataclasses.replace(MATCH_PRESETS["shipped"], codebook_size=512)
    db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                        wavlm=feats)
    engine = CodeKNNEngine(cfg, db, device=cuda)
    torch.manual_seed(82)
    encoder = WhisperEncoder(device=cuda)
    server = RawWavServer(engine, VQVAE(VQVAEConfig(), device=cuda), encoder)
    wav = rng.randint(-8192, 8192, (2, 6, 64000)).astype(np.int16)
    ctx = rng.randn(2, 6, 30, 384).astype(np.float32)

    def host(x, clips, c, init_code):
        enc = encoder(torch.as_tensor(x, device=cuda).float() / 32768.0,
                      clips=clips)[6 * c:6 * c + 6]
        return engine.predict(
            stage_test_audio(cfg, db, wavlm=enc.cpu().numpy()),
            stage_test_context(db, ctx[c]), init_code=init_code,
            init_phase=np.zeros((8, 16), np.float32),
            rng=np.random.RandomState(cfg.seed)).codes

    before = flash_attention_cuda.nobias_launches
    codes, poses = server.serve(wav[0], ctx[0], init_code=5,
                                rng=np.random.RandomState(cfg.seed))
    assert flash_attention_cuda.nobias_launches == before + 32
    np.testing.assert_array_equal(codes, host(wav[0], 1, 0, 5))
    assert poses.shape == (6 * 240, 135)
    batch, _ = server.serve_batch(wav, ctx, init_codes=np.array([5, 9]),
                                  init_phases=np.zeros((2, 8, 16),
                                                       np.float32))
    for c, init in enumerate((5, 9)):
        np.testing.assert_array_equal(batch[c],
                                      host(wav.reshape(12, -1), 2, c, init))
    with pytest.raises(ValueError, match="30 s context"):
        server.serve(np.zeros((8, 64000), np.int16), np.zeros((8, 30, 384),
                                                              np.float32))

    ckpt = tmp_path / "whisper"
    ckpt.mkdir()
    with open(ckpt / "config.json", "w") as f:
        json.dump(dataclasses.asdict(encoder.cfg), f)
    torch.save({f"encoder.{k}": v.cpu()
                for k, v in encoder.state_dict().items()},
               ckpt / "pytorch_model.bin")
    del server, encoder
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("db", "codes", "sig",
                                                    "feats")}
    fx["bundle"].save(paths["db"])
    save_codes(paths["codes"], fx["codes"])
    fx["signature"].save(paths["sig"])
    save_wavlm(paths["feats"], feats)
    args = argparse.Namespace(
        train_database=paths["db"], train_codebook=paths["codes"],
        codebook_signature=paths["sig"], train_wavlm=paths["feats"],
        train_wavvq=None, preset="shipped", wavvq_checkpoint=None,
        wavlm_checkpoint=None, w2v_bert_checkpoint=None,
        whisper_checkpoint=str(ckpt), device="cuda")
    audio = (rng.randn(16000 * 33) * 0.1).astype(np.float32)
    got, _ = cli._match_codes(args, audio)
    windows = database_builder.window_test_audio(audio)
    loaded = load_whisper_checkpoint(str(ckpt), device=cuda)
    want = CodeKNNEngine(cfg, db, device=cuda).predict(
        stage_test_audio(cfg, db, wavlm=database_builder.extract_utterances(
            loaded, windows)),
        stage_test_context(db, np.tile(
            database_builder.hashed_embed_fn()([""] * 30)[None],
            (windows.shape[0], 1, 1)).astype(np.float32))).codes
    np.testing.assert_array_equal(got, want)


# K4 against its plain version: float32 on both sides, summation order only
# (the plain version forms the (T, T) logits, the kernel an online softmax
# over 32-key tiles); (B, T, H, hd) projections seen as (B, H, T, hd), as
# w2v-BERT hands them. T = 37 is one partial tile, 199 w2v-BERT's window,
# 300 a longer one: +8 is reached in every case, -64 from T = 65 on.
@pytest.mark.parametrize("B,H,T,hd", [(1, 4, 37, 64), (16, 16, 199, 64),
                                      (2, 16, 300, 64), (2, 3, 130, 16)])
def test_relkey_kernel_matches_plain(cuda, B, H, T, hd):
    g = torch.Generator(device=cuda).manual_seed(T)
    q, k, v = torch.randn(3, B, T, H, hd, generator=g,
                          device=cuda).transpose(2, 3)
    emb = torch.randn(73, hd, generator=g, device=cuda)
    before = relkey_attention_cuda.launches
    got = relkey_attention_cuda.relkey_attention(
        q, k, v, emb, left=64, right=8, sm_scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert relkey_attention_cuda.launches == before + 1
    assert got.shape == (B, H, T, hd) and got.dtype == torch.float32
    want = relkey_attention_cuda.relkey_attention_plain(
        q, k, v, emb, left=64, right=8, sm_scale=hd ** -0.5)
    assert float((got - want).abs().max()) <= 1e-5


def test_w2v_bert_on_card_launches_k4_every_layer(cuda):
    """The published 24-layer w2v-BERT runs K4 once a layer (24 launches a
    forward), no fallback; a 2-layer one of width 64 (K4 at head width 16)
    gives the CPU port's features (float32 on both sides, summation
    order only, features of unit scale)."""
    from qpgesture_tpu_torch.models.w2v_bert import W2VBert, W2VBertConfig
    torch.manual_seed(0)
    wav = torch.randint(-8192, 8192, (2, 64000)).float() / 32768.0
    model = W2VBert(device=cuda)
    before = relkey_attention_cuda.launches
    out = model(wav.to(cuda))
    torch.cuda.synchronize()
    assert relkey_attention_cuda.launches == before + 24
    assert out.shape == (2, 199, 1024) and bool(torch.isfinite(out).all())
    del model, out
    small = W2VBertConfig(hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=128)
    cpu = W2VBert(small, device="cpu")
    card = W2VBert(small, device=cuda)
    card.load_state_dict(cpu.state_dict())
    torch.testing.assert_close(card(wav.to(cuda)).cpu(), cpu(wav),
                               atol=1e-4, rtol=0)


# vq-wav2vec's eight layers' frames at a clip's 6 and a batch's 96 windows,
# and a narrow C with ragged T (the scalar path where C T is not a multiple
# of 4). Tolerance: the kernel sums the moments in another order than
# PyTorch's, in float32 (mean and rstd ~1e-6 relative over 6.5 M
# elements), which moves outputs of magnitude up to ~6 by ~6e-6.
VQ_FRAMES = (12799, 3198, 1598, 798, 398)
K5_CASES = ([(B, 512, T, "gelu") for B in (6, 96) for T in VQ_FRAMES]
            + [(3, 32, T, act) for T in (1, 7, 399, 1001)
               for act in ("gelu", "relu")] + [(2, 3, 7, "gelu")])


@pytest.mark.parametrize("B,C,T,activation", K5_CASES)
def test_groupnorm_kernel_matches_plain(cuda, B, C, T, activation):
    g = torch.Generator(device=cuda).manual_seed(T)
    x = torch.randn(B, C, T, generator=g, device=cuda) * 3.0 + 0.5
    w = 1.0 + 0.1 * torch.randn(C, generator=g, device=cuda)
    b = 0.1 * torch.randn(C, generator=g, device=cuda)
    before = groupnorm_cuda.launches
    got = groupnorm_cuda.groupnorm1_act(x, w, b, 1e-5, activation)
    torch.cuda.synchronize()
    assert groupnorm_cuda.launches == before + 2
    want = groupnorm_cuda.groupnorm1_act_plain(x, w, b, 1e-5, activation)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_groupnorm_kernel_gives_the_same_bits_twice(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(6, 512, 12799, generator=g, device=cuda)
    w, b = torch.randn(2, 512, generator=g, device=cuda)
    first = groupnorm_cuda.groupnorm1_act(x, w, b, 1e-5, "gelu")
    second = groupnorm_cuda.groupnorm1_act(x, w, b, 1e-5, "gelu")
    assert torch.equal(first, second)


def test_vq_wav2vec_on_card_launches_k5_every_layer(cuda):
    """The benchmark's 8-layer vq-wav2vec: two K5 launches a layer, no
    fallback, and the codes of the same modules run through PyTorch's
    GroupNorm and GELU on the card (features to the kernel's tolerance, no
    served code's logit more than the benchmark's 3e-5 below the best)."""
    from qpgesture_tpu_torch.models.vq_wav2vec import (VQWav2Vec,
                                                       VQWav2VecConfig)
    torch.manual_seed(0)
    cfg = VQWav2VecConfig(conv_layers=((512, 10, 5), (512, 8, 4))
                          + ((512, 4, 2),) * 3 + ((512, 1, 1),) * 3,
                          weight_proj_depth=2)
    model = VQWav2Vec(cfg, device=cuda)
    wav = (torch.randint(-8192, 8192, (2, 64000)).float()
           / 32768.0).to(cuda)
    fe = model.feature_extractor
    before = groupnorm_cuda.launches
    feats = fe(wav)
    codes = model(wav)
    torch.cuda.synchronize()
    assert groupnorm_cuda.launches == before + 32
    with torch.no_grad():
        x = wav[:, None, :]
        for block in fe.conv_layers:
            x = block(x)
        want_feats = torch.log1p(x.abs()).transpose(1, 2)
        logits = model.vector_quantizer.weight_proj(want_feats).view(
            2, 398, 2, 320)
    torch.testing.assert_close(feats, want_feats, atol=1e-5, rtol=1e-5)
    gap = logits.max(-1).values - logits.gather(
        -1, codes.long()[..., None])[..., 0]
    assert float(gap.max()) <= 3e-5
    assert torch.equal(codes, logits.argmax(-1).to(torch.int32))


# K6 against its plain version (cuDNN's grouped conv1d, trim, GELU and the
# residual) at WavLM-Large's width: 16 groups of 64 channels, k = 128. Each
# output sums 8192 float32 products (inputs of unit scale, weights of
# ~0.006, sums up to ~3) in another order than cuDNN's, and adds inputs up
# to ~5: up to 1.24e-5 apart over these cases on an H100; 5e-5 leaves room.
K6_ATOL = 5e-5


def _posconv_inputs(cuda, B, T, C=1024, G=16, k=128, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    feats = torch.randn(B, T, C, generator=g, device=cuda)
    weight = torch.randn(C, C // G, k, generator=g, device=cuda) \
        * (4.0 / (k * C)) ** 0.5
    bias = 0.1 * torch.randn(C, generator=g, device=cuda)
    return feats, weight, bias, G


@pytest.mark.parametrize("B", [1, 6, 16])
@pytest.mark.parametrize("T", [1, 64, 199, 257])
def test_posconv_kernel_matches_plain(cuda, B, T):
    feats, weight, bias, G = _posconv_inputs(cuda, B, T, seed=B * 1000 + T)
    before = posconv_cuda.launches
    with torch.no_grad():
        got = posconv_cuda.posconv(feats, posconv_cuda.pack_weight(weight, G),
                                   bias)
        torch.cuda.synchronize()
        assert posconv_cuda.launches == before + 1
        want = posconv_cuda.posconv_plain(feats, weight, bias, G)
    torch.testing.assert_close(got, want, atol=K6_ATOL, rtol=0)


def test_posconv_kernel_takes_groups_of_48(cuda):
    """WavLM-Base's width: 768 channels in 16 groups of 48."""
    feats, weight, bias, G = _posconv_inputs(cuda, 3, 199, C=768)
    with torch.no_grad():
        got = posconv_cuda.posconv(feats, posconv_cuda.pack_weight(weight, G),
                                   bias)
        want = posconv_cuda.posconv_plain(feats, weight, bias, G)
    torch.testing.assert_close(got, want, atol=K6_ATOL, rtol=0)


def test_posconv_kernel_gives_the_same_bits_twice(cuda):
    feats, weight, bias, G = _posconv_inputs(cuda, 16, 199, seed=7)
    packed = posconv_cuda.pack_weight(weight, G)
    with torch.no_grad():
        first = posconv_cuda.posconv(feats, packed, bias)
        second = posconv_cuda.posconv(feats, packed, bias)
    assert torch.equal(first, second)


def test_posconv_kernel_refuses_misuse_on_card(cuda):
    feats, weight, bias, G = _posconv_inputs(cuda, 2, 50)
    packed = posconv_cuda.pack_weight(weight, G)
    with pytest.raises(RuntimeError, match="inference only"):
        posconv_cuda.posconv(feats, packed, bias.requires_grad_(True))
    bias.requires_grad_(False)
    odd = _posconv_inputs(cuda, 2, 50, k=12)
    with pytest.raises(ValueError, match="no kernel instantiation"):
        posconv_cuda.posconv(odd[0], posconv_cuda.pack_weight(odd[1], G),
                             odd[2])


def test_wavlm_highest_on_card_runs_k6(cuda):
    """A 2-layer WavLM at WavLM-Large's width and "highest": one K6 launch a
    forward, the span counter ``posconv_kernel`` 1, and the CPU port's
    features within 2e-4 (float32 on both sides, other summation orders
    through the layers; features of unit scale)."""
    from qpgesture_tpu_torch.models.wavlm import WavLM, WavLMConfig
    from qpgesture_tpu_torch.utils import profiling
    cfg = WavLMConfig(encoder_layers=2)
    torch.manual_seed(3)
    cpu = WavLM(cfg, device="cpu")
    card = WavLM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    wav = torch.from_numpy((np.random.RandomState(0).randn(2, 16000) * 0.2)
                           .astype(np.float32))
    before = posconv_cuda.launches
    with profiling.recording() as prof:
        with profiling.span("encode"):
            got = card(wav.to(cuda))
            torch.cuda.synchronize()
    assert posconv_cuda.launches == before + 1
    assert prof.take()[0]["counters"]["posconv_kernel"] == 1
    assert float((got.cpu() - cpu(wav)).abs().max()) <= 2e-4


# K7 against its plain version, bit for bit: mins compared as int32 bits
# (a -0.0 found first stays -0.0), args and matched exactly.
def _segmin_on_card(cuda, dist, seg, k, want=None):
    before = segmin_cuda.launches
    got = segmin_cuda.segment_min_argmin(dist.to(cuda), seg.to(cuda), k,
                                         segmin_cases.UNMATCHED)
    torch.cuda.synchronize()
    assert segmin_cuda.launches == before + 2
    if want is None:
        want = segmin_cuda.segment_min_argmin_plain(
            dist.cpu(), seg.cpu(), k, segmin_cases.UNMATCHED)
    mins, args, matched = (g.cpu() for g in got)
    assert mins.dtype == torch.float32 and args.dtype == torch.int64
    assert torch.equal(matched, want[2].cpu())
    assert torch.equal(args, want[1].cpu())
    assert torch.equal(mins.view(torch.int32), want[0].cpu().view(torch.int32))
    return got


@pytest.mark.parametrize("name", segmin_cases.CASES)
def test_segmin_kernel_matches_plain(cuda, name):
    """tests/test_torch_segmin.py's cases: ties, negative distances and
    both zeros, codes that never occur, ragged N (the scalar path), Q = 1,
    48 and 768, int32."""
    dist, seg, k = segmin_cases._case(
        name, np.random.RandomState(segmin_cases.CASES.index(name)))
    _segmin_on_card(cuda, torch.from_numpy(dist), torch.from_numpy(seg), k)


def test_segmin_kernel_keeps_non_finite_cases(cuda):
    inf, nan = float("inf"), float("nan")
    dist = torch.tensor([[1.0, inf, inf, -inf, 2.0, nan, 0.5, inf]])
    seg = torch.tensor([0, 1, 1, 2, 2, 3, 3, 5])
    mins, args, matched = _segmin_on_card(cuda, dist, seg, 6)
    assert args.tolist() == [[0, 1, 3, 0, 0, 7]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_segmin_kernel_tie_across_the_split(cuda, dtype):
    """Equal least distances of one code on both sides of each boundary of
    the N split: the first position wins whichever block saw it."""
    Q, N, k = 48, 26624, 512
    splits, chunk = segmin_cuda.plan(
        Q, N, *segmin_cuda._resident(cuda, k, int(dtype == torch.int32)))
    assert splits > 2
    g = torch.Generator().manual_seed(5)
    dist = (torch.randint(10, 20, (Q, N), generator=g)).to(dtype)
    seg = torch.randint(0, k, (N,), generator=g)
    for b in range(1, splits):
        edge = b * chunk
        seg[edge - 1] = seg[edge] = seg[edge + 1] = b
        dist[:, edge - 1: edge + 2] = 3
        dist[::2, edge - 1] = 4          # even rows: the tie starts at edge
    mins, args, _ = _segmin_on_card(cuda, dist, seg, k)
    for b in range(1, splits):
        assert args[1, b].item() == b * chunk - 1
        assert args[0, b].item() == b * chunk


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("Q", [48, 768])
def test_segmin_kernel_at_the_vq_cells_shapes(cuda, Q, dtype):
    """The vq-wav2vec clip's and batch's queries against 425 984 positions
    and 512 codes: cosine-like float32 distances (some below 0) or K1-like
    int32 edit distances, against the plain version on the card; the same
    bits a second time."""
    N, k = 425984, 512
    g = torch.Generator(device=cuda).manual_seed(Q)
    if dtype == torch.float32:
        dist = 1.0 - torch.rand(Q, N, generator=g, device=cuda) * 1.0001
    else:
        dist = torch.randint(0, 23, (Q, N), generator=g, device=cuda,
                             dtype=torch.int32)
    seg = torch.randint(0, k, (N,), generator=g, device=cuda)
    want = segmin_cuda.segment_min_argmin_plain(dist, seg, k,
                                                segmin_cases.UNMATCHED)
    got = _segmin_on_card(cuda, dist, seg, k, want)
    again = segmin_cuda.segment_min_argmin(dist, seg, k,
                                           segmin_cases.UNMATCHED)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_wavvq_clip_and_batch_on_card_run_k7(cuda):
    """A wavvq clip (predict) and a batch of 3 clips (predict_batch) on the
    card give the CPU port's codes, with the tables span's counter
    ``segmin_kernel`` 2 (both sides) for each unit."""
    rng = np.random.RandomState(14)
    fx = make_fixture(rng, n_seq=6, n_test=3, codebook=64)
    cfg = dataclasses.replace(MATCH_PRESETS["wavvq"], codebook_size=64)
    db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                        wavvq=fx["wavvq"])
    ta = stage_test_audio(cfg, db, wavvq=fx["test_wavvq"])
    tc = stage_test_context(db, fx["test_context"])
    cpu = CodeKNNEngine(cfg, db, device="cpu")
    card = CodeKNNEngine(cfg, db, device=cuda)
    clips_a, clips_c = np.stack([ta] * 3), np.stack([tc] * 3)
    init = np.array([3, 17, 40])
    with profiling.recording() as prof:
        got = card.predict(ta, tc, rng=np.random.RandomState(1))
        got_b = card.predict_batch(clips_a, clips_c, init_codes=init,
                                   rng=np.random.RandomState(2))
    want = cpu.predict(ta, tc, rng=np.random.RandomState(1))
    want_b = cpu.predict_batch(clips_a, clips_c, init_codes=init,
                               rng=np.random.RandomState(2))
    np.testing.assert_array_equal(got.codes, want.codes)
    for g_, w_ in zip(got_b, want_b):
        np.testing.assert_array_equal(g_.codes, w_.codes)
    tables = [r for r in prof.take() if r["name"] == "tables"]
    assert len(tables) == 2
    assert [r["counters"]["segmin_kernel"] for r in tables] == [2, 2]


def test_flash_attention_kernel_takes_unaligned_bias(cuda):
    """An (H, T, T) bias whose rows are not 16-byte aligned (T = 50) is
    copied into the kernel's layout; prepare_bias gives the same result
    and is returned as it is when passed again."""
    q, k, v, bias, gate = (x.to(cuda) for x in
                           _attention_inputs(2, 4, 50, 64, True))
    for dtype in (torch.float32, torch.bfloat16):
        prepared = flash_attention_cuda.prepare_bias(bias, dtype)
        assert flash_attention_cuda.prepare_bias(prepared, dtype) is prepared
        a = flash_attention_cuda.gated_flash_attention(
            q, k, v, bias, gate, kernel_dtype=dtype)
        b = flash_attention_cuda.gated_flash_attention(
            q, k, v, prepared, gate, kernel_dtype=dtype)
        assert torch.equal(a, b)


def test_wavlm_default_on_card_matches_cpu(cuda):
    """A small WavLM at precision="default": the card's bfloat16 GEMMs and
    bfloat16 K2 against the CPU's rounded-operand float32 emulation, the
    same operands summed in other orders (features of scale ~4)."""
    from qpgesture_tpu_torch.models.wavlm import WavLM, WavLMConfig
    cfg = WavLMConfig(encoder_layers=2, encoder_embed_dim=64,
                      encoder_ffn_embed_dim=128, encoder_attention_heads=4,
                      num_buckets=32, max_distance=80, precision="default",
                      conv_feature_layers=((32, 10, 5), (32, 3, 2),
                                           (32, 3, 2)))
    torch.manual_seed(3)
    cpu = WavLM(cfg, device="cpu")
    card = WavLM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    wav = torch.from_numpy((np.random.RandomState(0).randn(2, 3200) * 0.2)
                           .astype(np.float32))
    before = flash_attention_cuda.launches
    got = card(wav.to(cuda))
    assert flash_attention_cuda.launches == before + cfg.encoder_layers
    assert float((got.cpu() - cpu(wav)).abs().max()) <= 5e-2


def test_flash_attention_kernel_rejects_unbuilt_head_dim(cuda):
    q, k, v, bias, gate = (x.to(cuda) for x in
                           _attention_inputs(1, 2, 8, 48, True))
    with pytest.raises(ValueError, match="no kernel instantiation"):
        flash_attention_cuda.gated_flash_attention(q, k, v, bias, gate)


@pytest.mark.parametrize("preset", ["wavvq", "shipped", "mfcc"])
def test_engine_on_card_matches_cpu(cuda, preset):
    rng = np.random.RandomState(12)
    fx = make_fixture(rng, n_seq=6, n_test=3, codebook=64)
    cfg = dataclasses.replace(MATCH_PRESETS[preset], codebook_size=64)
    db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                        wavlm=fx["wavlm"], wavvq=fx["wavvq"])
    ta = stage_test_audio(cfg, db, test_bundle=fx["test_bundle"],
                          wavlm=fx["test_wavlm"], wavvq=fx["test_wavvq"])
    tc = stage_test_context(db, fx["test_context"]) if cfg.use_txt else None
    want = CodeKNNEngine(cfg, db, device="cpu").predict(ta, tc)
    got = CodeKNNEngine(cfg, db, device=cuda).predict(ta, tc)
    np.testing.assert_array_equal(got.codes, want.codes)
    if want.phases is not None:
        np.testing.assert_array_equal(got.phases, want.phases)


@pytest.mark.parametrize("preset", ["wavvq", "shipped"])
def test_scan_on_card_matches_cpu(cuda, preset):
    """The scan's pairs sliced from the resident phase / amp on the card:
    its codes, phases and votes equal the CPU port's engine's."""
    rng = np.random.RandomState(13)
    fx = make_fixture(rng, n_seq=6, n_test=3, codebook=64)
    cfg = dataclasses.replace(MATCH_PRESETS[preset], codebook_size=64)
    db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                        wavlm=fx["wavlm"], wavvq=fx["wavvq"])
    ta = stage_test_audio(cfg, db, wavlm=fx["test_wavlm"],
                          wavvq=fx["test_wavvq"])
    tc = stage_test_context(db, fx["test_context"])
    want = CodeKNNEngine(cfg, db, device="cpu").predict(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    card = CodeKNNEngine(cfg, db, device=cuda)
    assert card.dev.phase.is_cuda and card.dev.amp.is_cuda
    got = card.predict(ta, tc, rng=np.random.RandomState(cfg.seed))
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.phases, want.phases)
    np.testing.assert_array_equal(got.votes, want.votes)


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
@pytest.mark.parametrize("preset", ["wavvq", "shipped"])
def test_predict_sharded_on_card_matches_one_device(cuda, preset, world,
                                                    backend):
    """predict_sharded in a process group on the card (one NCCL rank, or
    two gloo ranks sharing cuda:0): every rank's codes, phases and votes
    equal the single-device predict; K1 runs on each wavvq shard."""
    import torch_dist_cases
    from qpgesture_tpu_torch.parallel.dist import spawn
    rng = np.random.RandomState(12)
    fx = make_fixture(rng, n_seq=7, n_test=3, codebook=64)
    cfg = dataclasses.replace(MATCH_PRESETS[preset], codebook_size=64)
    db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                        wavlm=fx["wavlm"], wavvq=fx["wavvq"])
    ta = stage_test_audio(cfg, db, wavlm=fx["test_wavlm"],
                          wavvq=fx["test_wavvq"])
    tc = stage_test_context(db, fx["test_context"])
    want = CodeKNNEngine(cfg, db, device=cuda).predict(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    ranks = spawn(torch_dist_cases.run, world, ({"p": (
        "on_device", (cfg, db, ta, tc, cfg.seed, "cuda:0"))},),
        backend=backend)
    for r in ranks:
        codes, phases, votes, k1 = r["p"]
        np.testing.assert_array_equal(codes, want.codes)
        np.testing.assert_array_equal(phases, want.phases)
        assert (votes is None) == (want.votes is None)
        if votes is not None:
            np.testing.assert_array_equal(votes, want.votes)
        assert k1 >= 1 if preset == "wavvq" else k1 == 0


def _kernel_against_loop(cuda, case):
    """The card's fusion scan (the kernel, one launch) against the CPU
    port's plain loop on the same inputs: blocks, phases and votes bit for
    bit."""
    want = eng._fuse_scan_clips(*case)
    before = fusion_scan_cuda.launches
    got = eng._fuse_scan_clips(*scan_cases.on_device(case, cuda))
    torch.cuda.synchronize()
    assert fusion_scan_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("C", [1, 16])
@pytest.mark.parametrize("resets", ["start", "windows"])
@pytest.mark.parametrize("flags", sorted(scan_cases.FLAGS))
def test_fusion_scan_kernel_matches_loop(cuda, flags, C, resets):
    """Each flag combination, pairs sliced from phase / amp at clamped
    starts, one lane or 16, resets at each lane's start or at every window
    (chain_windows=False, W = 3)."""
    _kernel_against_loop(cuda, scan_cases.make_scan_case(
        7 * C + len(flags), flags, C, 3, resets))


def test_fusion_scan_kernel_long_lanes_at_full_width(cuda):
    """Three lanes of 160 steps (20 windows, past a clip's 48) at 512
    codes, the kernel's largest staged rows, and no reset: every lane
    starts from code 0 and a zero phase."""
    _kernel_against_loop(cuda, scan_cases.make_scan_case(
        5, "phase_both", 3, 20, "none", P=512))


@pytest.mark.parametrize("entry", ["predict", "predict_batch", "pool"])
@pytest.mark.parametrize("code", [-1, 64])
def test_fusion_scan_refuses_out_of_range_init_codes_on_card(cuda, entry,
                                                            code):
    """An init code outside the 64 codes is refused on the host, before the
    kernel (which indexes the selection rows with it unchecked) is
    launched; the card then serves a valid request as the CPU port does."""
    from test_torch_fusion_scan import _engine, refused_codes
    card, ta, tc = _engine(cuda)
    before = fusion_scan_cuda.launches
    refused_codes(card, ta, tc, code, entry)
    assert fusion_scan_cuda.launches == before
    got = card.predict(ta, tc, init_code=63)
    torch.cuda.synchronize()
    assert fusion_scan_cuda.launches == before + 1
    np.testing.assert_array_equal(
        got.codes, _engine()[0].predict(ta, tc, init_code=63).codes)


def _wavvq_engines(cuda, n_test=4):
    rng = np.random.RandomState(14)
    fx = make_fixture(rng, n_seq=6, n_test=n_test, codebook=64)
    cfg = dataclasses.replace(MATCH_PRESETS["wavvq"], codebook_size=64)
    db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                        wavvq=fx["wavvq"])
    ta = stage_test_audio(cfg, db, wavvq=fx["test_wavvq"])
    tc = stage_test_context(db, fx["test_context"])
    return (CodeKNNEngine(cfg, db, device="cpu"),
            CodeKNNEngine(cfg, db, device=cuda), ta, tc)


def test_lane_scan_on_card_matches_cpu(cuda):
    """predict_batch (4 lanes x 1 window, 2 x 2) on staged wavvq tables,
    whose distances are integers: the card's lanes equal the CPU's codes
    and phases exactly, and launch K1 once per batch."""
    cpu, card, ta, tc = _wavvq_engines(cuda)
    for C in (4, 2):
        clips = lambda x: x.reshape((C, -1) + x.shape[1:])
        inits = np.arange(C, dtype=np.int32) * 7
        want = cpu.predict_batch(clips(ta), clips(tc), init_codes=inits)
        before = levenshtein_cuda.launches
        got = card.predict_batch(clips(ta), clips(tc), init_codes=inits)
        assert levenshtein_cuda.launches == before + 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.codes, w.codes)
            np.testing.assert_array_equal(g.phases, w.phases)
            np.testing.assert_array_equal(g.votes, w.votes)


def test_streaming_tick_and_push_make_no_host_sync(cuda):
    """A StreamingPool tick and a StreamingSession push queue their work,
    the fusion scan kernel's mask upload included, without waiting for the
    card (torch's sync debug mode raises on any synchronising call); their
    codes then equal the CPU port's."""
    from qpgesture_tpu_torch.serve import StreamingPool, StreamingSession
    cpu, card, ta, tc = _wavvq_engines(cuda)
    outs = {}
    for name, eng in (("cpu", cpu), ("card", card)):
        pool = StreamingPool(eng, 3, rngs=[np.random.RandomState(i)
                                           for i in range(3)])
        sess = StreamingSession(eng, rng=np.random.RandomState(5))
        pool.tick(ta[:3], tc[:3])                  # warm-up
        sess.push_window(ta[0], tc[0])
        if name == "card":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        scans = fusion_scan_cuda.launches
        try:
            a = pool.tick_device(ta[1:4], tc[1:4],
                                 active=np.array([True, False, True]))
            b = sess.push_window_device(ta[1], tc[1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        # the card's tick and push each ran the scan kernel, its reset mask
        # uploaded without a sync
        assert fusion_scan_cuda.launches - scans == (2 if name == "card"
                                                     else 0)
        outs[name] = (a.cpu().numpy(), b.cpu().numpy(),
                      *(x.cpu().numpy() for x in pool.state()))
    for g, w in zip(outs["card"], outs["cpu"]):
        np.testing.assert_array_equal(g, w)


def test_wavlm_high_on_card_matches_cpu(cuda):
    """A small WavLM at precision="high": three cuBLAS bfloat16 GEMMs per
    contraction and float32 K2 on the card, the CPU's float32 emulation of
    the same split products: other summation orders only."""
    from qpgesture_tpu_torch.models.wavlm import WavLM, WavLMConfig
    cfg = WavLMConfig(encoder_layers=2, encoder_embed_dim=64,
                      encoder_ffn_embed_dim=128, encoder_attention_heads=4,
                      num_buckets=32, max_distance=80, precision="high",
                      conv_feature_layers=((32, 10, 5), (32, 3, 2),
                                           (32, 3, 2)))
    torch.manual_seed(3)
    cpu = WavLM(cfg, device="cpu")
    card = WavLM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    wav = torch.from_numpy((np.random.RandomState(0).randn(2, 3200) * 0.2)
                           .astype(np.float32))
    before = flash_attention_cuda.launches
    got = card(wav.to(cuda))
    assert flash_attention_cuda.launches == before + cfg.encoder_layers
    assert float((got.cpu() - cpu(wav)).abs().max()) <= 1e-3


def test_minilm_on_card_matches_cpu(cuda):
    """A small MiniLM in float32 (TF32 off) on the card against the CPU."""
    from qpgesture_tpu_torch.models.minilm import (MiniLM, MiniLMConfig,
                                                   mean_pool)
    cfg = MiniLMConfig(vocab_size=120, hidden_size=48, num_layers=2,
                       num_heads=4, intermediate_size=96,
                       max_position_embeddings=64)
    torch.manual_seed(1)
    cpu = MiniLM(cfg, device="cpu")
    card = MiniLM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, 120, (3, 17))
    mask = (torch.arange(17)[None] < torch.tensor([[17], [9], [5]])).long()
    want = mean_pool(cpu(ids, mask), mask)
    got = mean_pool(card(ids.to(cuda), mask.to(cuda)), mask.to(cuda))
    assert float((got.cpu() - want).abs().max()) <= 1e-5


def test_pae_phases_on_card_match_cpu(cuda):
    """PhaseExtractor at the default PAE width (240-tap convs, 15 joints x
    9, 8 channels) over a 300-frame pose, the card against the CPU: float32
    on both sides (TF32 off), the phase compared on the circle."""
    from qpgesture_tpu_torch.core.config import PAEConfig
    from qpgesture_tpu_torch.models.pae import PAE, PhaseExtractor
    torch.manual_seed(4)
    cpu = PAE(PAEConfig(), device="cpu")
    card = PAE(PAEConfig(), device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(4)
    pose = rng.randn(300, 135).astype(np.float32)
    mean, std = pose.mean(0), pose.std(0)
    want = PhaseExtractor(cpu, device="cpu").pose_to_phase(pose, mean, std,
                                                          batch=128)
    got = PhaseExtractor(card, device=cuda).pose_to_phase(pose, mean, std,
                                                         batch=128)
    d = np.abs(got[:, 0] - want[:, 0]) % 1
    assert float(np.minimum(d, 1 - d).max()) <= 1e-4
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=1e-4)


def _vqvae_pair(cuda):
    from qpgesture_tpu_torch.core.config import VQVAEConfig
    from qpgesture_tpu_torch.models.vqvae import VQVAE
    cfg = VQVAEConfig(width=64, emb_width=64, l_bins=64, depth=2)
    torch.manual_seed(5)
    cpu = VQVAE(cfg, device="cpu")
    cpu.init_codebook_from_batch(torch.randn(8, 240, 135),
                                 np.random.RandomState(5))
    card = VQVAE(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def test_encode_windows_on_card_matches_cpu(cuda):
    from qpgesture_tpu_torch.pipelines.database_builder import encode_windows
    cpu, card = _vqvae_pair(cuda)
    rng = np.random.RandomState(6)
    body = rng.randn(70, 240, 135).astype(np.float32)
    mean = (rng.randn(135) * 0.1).astype(np.float32)
    std = rng.rand(135).astype(np.float32) + 0.5
    want = encode_windows(cpu, body, mean, std)
    got = encode_windows(card, body, mean, std)
    assert got.dtype == np.int32 and got.shape == (70, 30)
    np.testing.assert_array_equal(got, want)


def test_codebook_signature_on_card_matches_cpu(cuda):
    from qpgesture_tpu_torch.models.vqvae import codebook_signature
    cpu, card = _vqvae_pair(cuda)
    rng = np.random.RandomState(7)
    mean, std = rng.randn(135) * 0.1, rng.rand(135) + 0.5
    for got, want in zip(codebook_signature(card, mean, std),
                         codebook_signature(cpu, mean, std)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("precision,feat_dtype", [
    ("high", "float32"), ("default", "float32"), ("highest", "bfloat16"),
    ("highest", "float16")])
def test_cosine_tables_on_card_match_cpu(cuda, precision, feat_dtype):
    """The cosine tables at "high" (bf16x3) and "default", and under bf16 /
    f16 residency. A database cast on the host is bit-equal on both
    devices; a split made on each device from its own float32-normalized
    rows agrees within one bfloat16 step ("default") or 2e-5 (hi + lo).
    Each device's distances are within 1e-5 of a float64 evaluation of its
    own rounded operands, and the codes are equal. (The devices' float32
    normalizations may differ by an ulp, which can move a component across
    a 16-bit rounding edge: their distances are not compared directly.)"""
    from qpgesture_tpu_torch.match import engine as eng
    rng = np.random.RandomState(15)
    fx = make_fixture(rng, n_seq=6, n_test=3, codebook=64)
    cfg = dataclasses.replace(MATCH_PRESETS["shipped"], codebook_size=64,
                              cosine_precision=precision,
                              feat_dtype=feat_dtype)
    db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                        wavlm=fx["wavlm"])
    ta = stage_test_audio(cfg, db, wavlm=fx["test_wavlm"])
    tc = stage_test_context(db, fx["test_context"])
    cpu = CodeKNNEngine(cfg, db, device="cpu")
    card = CodeKNNEngine(cfg, db, device=cuda)
    def parts(engine):
        feat = engine.devdb.aud_feat
        return feat if isinstance(feat, tuple) else (feat,)

    staged = [parts(e) for e in (cpu, card)]
    assert [t.dtype for t in staged[0]] == [t.dtype for t in staged[1]]
    if feat_dtype != "float32":
        assert torch.equal(staged[0][0], staged[1][0].cpu())
    else:
        recon = [sum(t.cpu().double() for t in side) for side in staged]
        tol = 2e-5 if precision == "high" else 2.0 ** -8
        assert float((recon[0] - recon[1]).abs().max()) <= tol
    from qpgesture_tpu_torch.ops.precision import split_bf16
    q = torch.from_numpy(ta.reshape(-1, ta.shape[-1]))
    for engine, qd in ((cpu, q), (card, q.to(cuda))):
        dn = engine.devdb.aud_feat
        got = eng.cosine_distance_prenorm(qd, dn).double()
        qn = eng._l2_normalize(qd)
        if isinstance(dn, tuple):
            q_hi, q_lo = (t.double() for t in split_bf16(qn))
            d_hi, d_lo = (t.double() for t in dn)
            want = 1 - (q_hi @ d_hi.T + q_hi @ d_lo.T + q_lo @ d_hi.T)
        else:
            want = 1 - qn.to(dn.dtype).double() @ dn.double().T
        assert float((got - want).abs().max()) <= 1e-5
    np.testing.assert_array_equal(card.predict(ta, tc).codes,
                                  cpu.predict(ta, tc).codes)


def test_reference_ties_on_card_match_cpu(cuda):
    """wavvq: phase 1's integer distances through K1 on the card, the same
    host fusion: codes, phases and votes equal exactly."""
    cpu, card, ta, tc = _wavvq_engines(cuda)
    want = cpu.predict_reference_ties(ta, tc)
    before = levenshtein_cuda.launches
    got = card.predict_reference_ties(ta, tc)
    assert levenshtein_cuda.launches == before + 1
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.phases, want.phases)
    np.testing.assert_array_equal(got.votes, want.votes)


def test_resync_on_card_matches_cpu(cuda):
    from qpgesture_tpu_torch.models.resync import (ResyncNet,
                                                   predict_resynced_gesture)
    torch.manual_seed(16)
    cpu = ResyncNet(device="cpu")
    card = ResyncNet(device=cuda)
    card.load_state_dict(cpu.state_dict())
    card.eval()
    rng = np.random.RandomState(16)
    mfcc = rng.randn(4, 240, 13).astype(np.float32)
    knn = rng.randn(4, 240, 135).astype(np.float32)
    stats = (np.zeros(13), np.ones(13), np.zeros(135), np.ones(135))
    want = predict_resynced_gesture(cpu, mfcc, knn, *stats)
    got = predict_resynced_gesture(card, mfcc, knn, *stats)
    assert float(np.abs(got - want).max()) <= 1e-3 * float(knn.std())


def test_generator_gru_codes_on_card_match_cpu(cuda):
    from qpgesture_tpu_torch.models.gru_baseline import GeneratorGRU
    torch.manual_seed(17)
    cpu = GeneratorGRU(device="cpu")
    card = GeneratorGRU(device=cuda)
    card.load_state_dict(cpu.state_dict())
    card.project.flatten_parameters()
    card.eval()
    wins = torch.from_numpy((0.2 * np.random.RandomState(17).randn(
        3, 64000)).astype(np.float32))
    with torch.no_grad():
        want, got = cpu(wins), card(wins.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-4
    assert torch.equal(card.sample(wins.to(cuda)).cpu(), cpu.sample(wins))


# card against CPU gradients, per tensor ||g_card - g_cpu|| / ||g_cpu||:
# float32 on both devices with other summation orders, where an L1 loss
# term takes the other sign where output and target agree to rounding and
# the PAE's phase heads end in atan2(v1, v0), whose gradient grows as
# 1/|v|^2 near the origin (both reach 1e-3 to 2e-3 on an H100 in some
# runs); the losses and statistics hold the forward pass tightly. The PAE's
# BatchNorms average 240-tap conv outputs (32 400 products each).
GRAD_NORM_RTOL = 1e-2
PAE_STATS_RTOL = 1e-4


def _grad_err(card_model, cpu_model, zero_grad=()):
    """Worst per-tensor gradient error; tensors in zero_grad (gradient 0
    analytically: rounding noise on both devices) as their largest
    difference relative to the model's largest |g|."""
    cpu_params = dict(cpu_model.named_parameters())
    top = max(float(p.grad.abs().max()) for p in cpu_params.values())
    worst = 0.0
    for name, p in card_model.named_parameters():
        want = cpu_params[name].grad
        diff = p.grad.cpu() - want
        worst = max(worst, float(diff.abs().max()) / top if name in zero_grad
                    else float(diff.norm() / want.norm()))
    return worst


def _vqvae_trainers(cuda, **kw):
    from qpgesture_tpu_torch.core.config import TrainConfig, VQVAEConfig
    from qpgesture_tpu_torch.train.train_vqvae import VQVAETrainer
    cfg = VQVAEConfig(width=128, emb_width=128, l_bins=64, depth=2, **kw)
    tcfg = TrainConfig(batch_size=8)
    batch = torch.from_numpy((0.5 * np.random.RandomState(18).randn(
        8, 240, 135)).astype(np.float32))
    cpu = VQVAETrainer(cfg, tcfg, device="cpu", seed=18)
    cpu.init_codebook(batch)
    card = VQVAETrainer(cfg, tcfg, device=cuda, seed=18)
    card.load_state_dict(cpu.state_dict())
    return cpu, card, batch


def test_vqvae_train_step_on_card_matches_cpu(cuda):
    """One step from the same state and batch: loss 1e-5 relative, gradients
    GRAD_NORM_RTOL, codes equal, the EMA statistics and the codebook rows
    that stay in use 1e-5 (dead codes restart from each device's own
    draws)."""
    cpu, card, batch = _vqvae_trainers(cuda)
    codes_cpu = cpu.model.encode(batch)
    codes_card = card.model.encode(batch.to(cuda)).cpu()
    assert torch.equal(codes_card, codes_cpu)
    loss_cpu, _ = cpu.train_step(batch)
    loss_card, metrics = card.train_step(batch.to(cuda))
    assert abs(float(loss_card) - float(loss_cpu)) <= 1e-5 * float(loss_cpu)
    assert _grad_err(card.model, cpu.model) <= GRAD_NORM_RTOL
    a, b = card.model.codebook_block, cpu.model.codebook_block
    for name in ("k_sum", "k_elem"):
        assert float((getattr(a, name).cpu() - getattr(b, name)).abs().max()
                     ) <= 1e-5
    used = b.k_elem >= 1.0
    assert torch.equal(a.k_elem.cpu() >= 1.0, used)
    assert float((a.k.cpu()[used] - b.k[used]).abs().max()) <= 1e-5
    assert float(metrics["usage"]) == float(used.sum())


def test_vqvae_train_step_makes_no_host_sync(cuda, tmp_path):
    """A step on device-resident batches reads nothing back: it runs under
    torch's sync debug mode "error", also after a resume from a checkpoint
    mapped onto the card (Adam's step counts go back to the host)."""
    from qpgesture_tpu_torch.train.checkpoints import (restore_checkpoint,
                                                        save_checkpoint)
    _, card, batch = _vqvae_trainers(cuda)
    x = batch.to(cuda)
    card.train_step(x)                       # first step: optimizer state
    save_checkpoint(str(tmp_path), card.state_dict(1))
    card.load_state_dict(restore_checkpoint(str(tmp_path),
                                            map_location=cuda))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, metrics = card.train_step(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(loss)) and card.step == 2


def test_pae_train_step_on_card_matches_cpu(cuda):
    """One AdamW step of the full-width PAE at batch 8: loss 1e-5 relative,
    gradients GRAD_NORM_RTOL (biases feeding a training-mode BatchNorm,
    whose gradient is 0, to that of the model's largest |g|), BatchNorm
    statistics PAE_STATS_RTOL of each tensor's largest magnitude."""
    from qpgesture_tpu_torch.core.config import PAEConfig
    from qpgesture_tpu_torch.train.train_pae import PAETrainer
    cpu = PAETrainer(PAEConfig(), device="cpu", seed=19)
    card = PAETrainer(PAEConfig(), device=cuda, seed=19)
    x = torch.from_numpy(np.sin(np.linspace(0, 30, 8 * 240 * 135)).reshape(
        8, 240, 135).astype(np.float32))
    loss_cpu = cpu.train_step(x)
    loss_card = card.train_step(x.to(cuda))
    assert abs(float(loss_card) - float(loss_cpu)) <= 1e-5 * float(loss_cpu)
    fed = {"conv1.bias", "conv2.bias", "deconv1.bias"} | {
        f"fc.{i}.bias" for i in range(PAEConfig().phase_channels)}
    assert _grad_err(card.model, cpu.model, fed) <= GRAD_NORM_RTOL
    cpu_bufs = dict(cpu.model.named_buffers())
    for name, buf in card.model.named_buffers():
        if "running" in name:
            want = cpu_bufs[name]
            assert float((buf.cpu() - want).abs().max()) <= \
                PAE_STATS_RTOL * float(want.abs().max()), name


def test_end2end_train_step_on_card_matches_cpu(cuda):
    """One Adam step of the full-width GeneratorGRU at dropout 0 (the two
    devices' generators draw different masks): loss 1e-5 relative, gradients
    GRAD_NORM_RTOL (the BatchNorm-fed conv biases to GRAD_NORM_RTOL of the
    model's largest |g|), BatchNorm statistics 1e-5."""
    from qpgesture_tpu_torch.core.config import End2EndConfig
    from qpgesture_tpu_torch.train.train_end2end import End2EndTrainer
    cpu = End2EndTrainer(End2EndConfig(), device="cpu", seed=20)
    cpu.model.dropout = 0.0
    card = End2EndTrainer(End2EndConfig(), device=cuda, seed=20)
    card.model.dropout = 0.0
    rng = np.random.RandomState(20)
    wav = torch.from_numpy((0.2 * rng.randn(8, 64000)).astype(np.float32))
    codes = torch.from_numpy(rng.randint(0, 512, (8, 30)))
    loss_cpu = cpu.train_step(wav, codes)
    loss_card = card.train_step(wav.to(cuda), codes.to(cuda))
    assert abs(float(loss_card) - float(loss_cpu)) <= 1e-5 * float(loss_cpu)
    fed = {f"WavEncoder.feat_extractor.{k}.bias" for k in (0, 3, 6, 9)}
    assert _grad_err(card.model, cpu.model, fed) <= GRAD_NORM_RTOL
    cpu_bufs = dict(cpu.model.named_buffers())
    for name, buf in card.model.named_buffers():
        if "running" in name:
            assert float((buf.cpu() - cpu_bufs[name]).abs().max()) <= 1e-5


# a LeakyReLU input within rounding of 0 takes the other slope on one
# device, and the gradient penalty differentiates the slopes again: one such
# element moves a layer's gradient by ~1e-3 of its norm (chip_smoke.py's
# RESYNC_GRAD_RTOL, with the float64 reference it logs)
RESYNC_GRAD_RTOL = 3e-2


def _resync_trainers(cuda):
    from qpgesture_tpu_torch.core.config import ResyncConfig
    from qpgesture_tpu_torch.train.train_resync import ResyncTrainer
    cfg = ResyncConfig(gen_hop=1)
    cpu = ResyncTrainer(cfg, n_mfcc=13, n_joints=135, num_frames=240,
                        device="cpu", seed=21)
    card = ResyncTrainer(cfg, n_mfcc=13, n_joints=135, num_frames=240,
                         device=cuda, seed=21)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(21)
    x_knn, x_real = (torch.from_numpy(rng.randn(8, 240, 148).astype(
        np.float32)) for _ in range(2))
    return cpu, card, x_knn, x_real


def test_resync_iteration_on_card_matches_cpu(cuda):
    """One critic step and one generator step of the full-width ResyncNet
    and critic at batch 8 from the same weights and interpolation points,
    the generator step against the same critic (Adam with b1 = 0 moves each
    weight by about lr times its gradient's sign, so weights whose gradient
    is rounding noise leave the two updated critics ~lr apart): losses 1e-5
    relative, gradients RESYNC_GRAD_RTOL (the conv biases that feed a
    BatchNorm or an InstanceNorm, whose gradient is 0, to that of the
    model's largest |g|), BatchNorm statistics 1e-5 relative to each
    tensor's largest magnitude."""
    cpu, card, x_knn, x_real = _resync_trainers(cuda)
    eps = torch.rand((8, 1, 1), generator=torch.Generator().manual_seed(21))
    knn, real = x_knn.to(cuda), x_real.to(cuda)
    want = {"d_loss": cpu.d_step(x_knn, x_real, eps)}
    got = {"d_loss": card.d_step(knn, real, eps.to(cuda))}
    card.disc.load_state_dict(cpu.disc.state_dict())
    want["g_loss"] = cpu.g_step(x_knn, x_real)
    got["g_loss"] = card.g_step(knn, real)
    for key in ("d_loss", "g_loss"):
        assert abs(float(got[key]) - float(want[key])) <= \
            1e-5 * max(abs(float(want[key])), 1.0), key
    for a, b in ((card.disc, cpu.disc), (card.gen, cpu.gen)):
        fed = {n for n, _ in b.named_parameters()
               if n.endswith((".0.bias", ".3.bias"))}
        assert _grad_err(a, b, fed) <= RESYNC_GRAD_RTOL
    cpu_bufs = dict(cpu.gen.named_buffers())
    for name, buf in card.gen.named_buffers():
        if "running" in name:
            want = cpu_bufs[name]
            assert float((buf.cpu() - want).abs().max()) <= \
                1e-5 * float(want.abs().max()), name


def test_resync_iteration_makes_no_host_sync(cuda):
    _, card, x_knn, x_real = _resync_trainers(cuda)
    knn, real = x_knn.to(cuda), x_real.to(cuda)
    card.train_iteration(knn, real, 0)          # optimizer state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logs = card.train_iteration(knn, real, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sorted(logs) == ["d_loss", "g_loss"] and card.step == 2


def test_fgd_encoder_on_card_matches_cpu(cuda):
    from qpgesture_tpu_torch.render.fgd_extractor import (FGDAutoencoder,
                                                          FGDExtractorConfig,
                                                          fgd_encoder_fn)
    torch.manual_seed(22)
    cpu = FGDAutoencoder(FGDExtractorConfig(), device="cpu").eval()
    card = FGDAutoencoder(FGDExtractorConfig(), device=cuda).eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(22)
    wins = rng.randn(16, 240, 135).astype(np.float32)
    mean, std = rng.randn(135) * 0.1, rng.rand(135) + 0.5
    want = fgd_encoder_fn(cpu, mean, std)(wins)
    got = fgd_encoder_fn(card, mean, std)(wins)
    assert float(np.abs(got - want).max()) <= 1e-5 * float(
        np.abs(want).max())


def test_rawpose_batch_on_card_matches_cpu_and_solo(cuda):
    """search_motion_batch over a staged database of tests/fixtures.py's
    shapes: bit-equal to the CPU port and, lane by lane, to a solo
    search_motion on the card."""
    from qpgesture_tpu_torch.match.gesture_knn import (
        GestureKNNEngine, normalize_gesture_knn, stage_gesture_knn)
    rng = np.random.RandomState(23)
    mfcc = rng.randn(32, 240, 14).astype(np.float32)
    body = rng.randn(32, 240, 135).astype(np.float32)
    db, test = normalize_gesture_knn(stage_gesture_knn(mfcc, body),
                                     rng.randn(4, 240, 14).astype(np.float32))
    seqs, frms = np.array([0, 5, 9, 31]), np.array([0, 100, 17, 200])
    ks = np.array([0, 1, 3, 0])
    card = GestureKNNEngine(db, device=cuda)
    got = card.search_motion_batch(test, seqs, frms, ks)
    want = GestureKNNEngine(db, device="cpu").search_motion_batch(
        test, seqs, frms, ks)
    np.testing.assert_array_equal(got, want)
    for c in range(4):
        np.testing.assert_array_equal(got[c], card.search_motion(
            test[c], int(seqs[c]), int(frms[c]), int(ks[c])))


@pytest.mark.parametrize("precision", ["default", "high"])
def test_precision_convs_on_card_match_cpu(cuda, precision):
    """The "default" / "high" convs as cuBLAS GEMMs with float32 output on
    the card against the CPU's widened products: the same rounded operands,
    other summation orders (1e-5 of the output's size), forward and both
    gradients."""
    from qpgesture_tpu_torch.models.encdec import Conv1d, ConvTranspose1d
    for make in (lambda: Conv1d(64, 48, 3, 1, 3, 3, precision=precision),
                 lambda: ConvTranspose1d(64, 48, 4, 2, 1,
                                         precision=precision)):
        torch.manual_seed(30)
        cpu = make()
        card = make().to(cuda)
        card.load_state_dict(cpu.state_dict())
        x = torch.randn(4, 64, 60, requires_grad=True)
        xc = x.detach().to(cuda).requires_grad_()
        y, yc = cpu(x), card(xc)
        assert float((yc.cpu() - y).abs().max()) <= 1e-5 * float(
            y.abs().max())
        g = torch.randn_like(y)
        y.backward(g)
        yc.backward(g.to(cuda))
        for a, b in ((xc.grad, x.grad), (card.weight.grad, cpu.weight.grad)):
            assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(
                b.abs().max())


# "default" card against CPU: the same bfloat16 rounding, but a float32
# activation one ulp apart between the two can round its operand the other
# way (2^-8 of it), and the layers carry such flips into the loss and the
# gradients (2-3e-2 per tensor norm for one step on an H100; an error in the
# step gives O(1)). "high"'s split carries no such flip.
DEFAULT_LOSS_RTOL, DEFAULT_GRAD_RTOL = 5e-3, 0.1


@pytest.mark.parametrize("precision", ["default", "high"])
def test_vqvae_train_step_at_precision_on_card_matches_cpu(cuda, precision):
    """One VQ-VAE step at conv_precision "default" / "high", card against
    CPU from the same state and batch: "high" as "highest" is held (codes
    equal, loss 1e-5 relative, gradients GRAD_NORM_RTOL), "default" within
    DEFAULT_LOSS_RTOL / DEFAULT_GRAD_RTOL; no host sync in the step."""
    cpu, card, batch = _vqvae_trainers(cuda, conv_precision=precision)
    default = precision == "default"
    if not default:
        assert torch.equal(card.model.encode(batch.to(cuda)).cpu(),
                           cpu.model.encode(batch))
    loss_cpu, _ = cpu.train_step(batch)
    loss_card, _ = card.train_step(batch.to(cuda))
    assert abs(float(loss_card) - float(loss_cpu)) <= \
        (DEFAULT_LOSS_RTOL if default else 1e-5) * float(loss_cpu)
    assert _grad_err(card.model, cpu.model) <= \
        (DEFAULT_GRAD_RTOL if default else GRAD_NORM_RTOL)
    x = batch.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card.train_step(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_simple_vqvae_and_seq2seq_on_card_match_cpu(cuda):
    """SimpleVQVAE (cuDNN LSTM) codes equal and decode 1e-5; Seq2SeqNet's
    eval forward (packed cuDNN GRUs, per-step decoder) within 1e-5."""
    from qpgesture_tpu_torch.core.config import VQVAEConfig
    from qpgesture_tpu_torch.models.seq2seq import Seq2SeqNet
    from qpgesture_tpu_torch.models.simple_vqvae import SimpleVQVAE
    torch.manual_seed(31)
    cpu = SimpleVQVAE(VQVAEConfig(), device="cpu")
    cpu.bottleneck.level_blocks[0].set_state(torch.randn(512, 512) * 0.05)
    card = SimpleVQVAE(VQVAEConfig(), device=cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(8, 240, 135)
    codes = cpu.encode(x)
    assert torch.equal(card.encode(x.to(cuda)).cpu(), codes)
    assert float((card.decode(codes.to(cuda)).cpu() - cpu.decode(codes)
                  ).abs().max()) <= 1e-5
    cpu = Seq2SeqNet(300, 32, 64, 27, 34, 4, 2, device="cpu")
    card = Seq2SeqNet(300, 32, 64, 27, 34, 4, 2, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(31)
    lengths = np.array([12, 3, 7, 12])
    tokens = torch.from_numpy(rng.randint(1, 300, (4, 12)))
    poses = torch.from_numpy(rng.randn(4, 34, 27).astype(np.float32))
    with torch.no_grad():
        want = cpu(tokens, lengths, poses)
        got = card(tokens.to(cuda), lengths, poses.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-5


def test_device_timing_on_card(cuda):
    """device_seconds_per_iter through a CUDA graph and eagerly agree on a
    GEMM within 30 %; chained steps time; the launch floor is positive."""
    from qpgesture_tpu_torch.utils import devtime
    a = torch.randn(2048, 2048, device=cuda)
    graphed, _ = devtime.device_seconds_per_iter(lambda x: x @ x, (a,),
                                                 graph=True)
    eager, _ = devtime.device_seconds_per_iter(lambda x: x @ x, (a,))
    assert graphed > 0 and abs(graphed - eager) <= 0.3 * eager
    chained, _ = devtime.chained_seconds_per_iter(
        lambda c, w: (torch.tanh(c @ w),), a, (a,))
    assert chained > 0
    assert devtime.measure_link_s() > 0
    assert devtime.peak_flops_per_s("bfloat16")[0] == \
        torch.cuda.get_device_name()


def test_bench_rawpose_and_pae_on_card(cuda):
    """The bench's raw-pose and PAE sections at their own shapes: each
    returns the JAX bench's keys with positive times, as JSON."""
    import json
    from qpgesture_tpu_torch import bench
    rng = np.random.RandomState(0)
    rawpose = json.loads(json.dumps(bench._bench_rawpose(rng)))
    pae = json.loads(json.dumps(bench._bench_pae(rng)))
    assert set(rawpose) == {"p50_ms", "gest_s_per_s", "n_seqs"}
    assert rawpose["n_seqs"] == 16 and rawpose["p50_ms"] > 0
    assert set(pae) == {"frames", "p50_ms", "frames_per_s"}
    assert pae["frames"] == bench.PAE_FRAMES and pae["p50_ms"] > 0


def test_long_clip_on_card_matches_cpu(cuda):
    """The reference's 3600-frame mfcc clip (one window of 113 steps, 450
    codes) on the card: equal to the CPU port's codes and to the oracle."""
    from qpgesture_tpu_torch.examples.chip_parity_sweep import \
        long_clip_codes
    got, oracle = long_clip_codes("cuda")
    cpu, _ = long_clip_codes("cpu")
    assert got.shape == (2, 450)
    np.testing.assert_array_equal(got, cpu)
    np.testing.assert_array_equal(got, oracle)


def test_predict_bucketed_on_card_matches_solo_predict(cuda):
    """predict_bucketed pads a clip to its bucket of windows: on the card
    its codes equal a solo predict of the same clip, and the CPU port's."""
    rng = np.random.RandomState(44)
    fx = make_fixture(rng, n_seq=8, n_test=3)
    cfg = MATCH_PRESETS["wavvq"]
    db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                        wavvq=fx["wavvq"])
    ta = stage_test_audio(cfg, db, wavvq=fx["test_wavvq"])
    tc = stage_test_context(db, fx["test_context"])
    engine = CodeKNNEngine(cfg, db, device="cuda")
    before = levenshtein_cuda.launches
    got = engine.predict_bucketed(ta, tc)
    assert levenshtein_cuda.launches > before
    assert got.codes.shape == (3, 30)
    np.testing.assert_array_equal(got.codes, engine.predict(ta, tc).codes)
    np.testing.assert_array_equal(
        got.codes,
        CodeKNNEngine(cfg, db, device="cpu").predict_bucketed(ta, tc).codes)
