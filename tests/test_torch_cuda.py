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
from qpgesture_tpu_torch.match.engine import CodeKNNEngine
from qpgesture_tpu_torch.ops import flash_attention_cuda, levenshtein_cuda

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
    """A StreamingPool tick and a StreamingSession push queue their work
    without waiting for the card (torch's sync debug mode raises on any
    synchronising call); their codes then equal the CPU port's."""
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
        try:
            a = pool.tick_device(ta[1:4], tc[1:4],
                                 active=np.array([True, False, True]))
            b = sess.push_window_device(ta[1], tc[1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
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
