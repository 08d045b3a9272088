"""Batched serving: the port's predict_batch (the lane-batched fusion scan),
predict_bucketed and RawWavServer.serve_batch against the JAX package's on
the same fixtures, seeds and weights, and against the port's own solo
paths."""
import zlib

import numpy as np
import pytest
import torch

from qpgesture_tpu.core.config import VQVAEConfig
from qpgesture_tpu.match import database as jax_db
from qpgesture_tpu.match import engine as jax_engine
from qpgesture_tpu.models import vq_wav2vec as jv
from qpgesture_tpu.models import wavlm as jw
from qpgesture_tpu.models.torch_convert import convert_vqvae
from qpgesture_tpu.models.vqvae import VQVAE as JaxVQVAE
from qpgesture_tpu.serve import RawWavServer as JaxRawWavServer
from qpgesture_tpu_torch.match import database as port_db
from qpgesture_tpu_torch.match import engine as port_engine
from qpgesture_tpu_torch.models import wavlm as pw
from qpgesture_tpu_torch.serve import RawWavServer

from fixtures import make_fixture
from test_torch_engine import SWEEP, _configs
from test_torch_rawwav import VQW2V_SMALL, WAVLM_SMALL, _port_vqw2v, _setup
from test_torch_serve import TINY
from test_torch_staging import port_config, stage


def _clips(x, C):
    return None if x is None else x.reshape((C, -1) + x.shape[1:])


def _engines(preset, n_test=4, **extra):
    rng = np.random.RandomState(2024 + zlib.crc32(preset.encode()) % 1000)
    fx = make_fixture(rng, n_seq=4, n_test=n_test, codebook=64)
    jcfg, pcfg = _configs(preset, **extra)
    jdb, ta, tc = stage(jax_db, jcfg, fx)
    pdb, _, _ = stage(port_db, pcfg, fx)
    return (jax_engine.CodeKNNEngine(jcfg, jdb),
            port_engine.CodeKNNEngine(pcfg, pdb, device="cpu"), ta, tc)


def _assert_results_equal(got, want):
    np.testing.assert_array_equal(got.codes, want.codes)
    for name in ("phases", "votes"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("preset", SWEEP)
def test_predict_batch_matches_jax(preset):
    """2 clips x 2 windows, seeds drawn from one rng on both sides (the
    batch's draw order: clip inits, per-window re-seeds for mfcc, rand bits
    for no_phase): codes, phases and votes bit-identical per clip."""
    extra = {"desired_k": 2} if preset == "no_phase" else {}
    jeng, peng, ta, tc = _engines(preset, **extra)
    C = 2
    want = jeng.predict_batch(_clips(ta, C), _clips(tc, C),
                              rng=np.random.RandomState(7))
    got = peng.predict_batch(_clips(ta, C), _clips(tc, C),
                             rng=np.random.RandomState(7))
    assert len(got) == len(want) == C
    for g, w in zip(got, want):
        assert g.codes.shape == (2, 30) and g.codes.dtype == np.int32
        _assert_results_equal(g, w)


@pytest.mark.parametrize("preset", ["wavvq", "shipped", "no_phase"])
def test_predict_batch_lanes_equal_solo_predict(preset):
    """Each lane of the batch equals the port's solo predict of its clip
    with the same explicit init code and phase (4 clips x 1 window and
    2 x 2)."""
    _, peng, ta, tc = _engines(preset)
    rng = np.random.RandomState(5)
    for C in (4, 2):
        inits = rng.randint(0, 64, C).astype(np.int32)
        phases = rng.rand(C, 8, 16).astype(np.float32)
        batch = peng.predict_batch(_clips(ta, C), _clips(tc, C),
                                   init_codes=inits, init_phases=phases,
                                   rng=np.random.RandomState(3))
        for c in range(C):
            # no_phase draws its rand bits from the rng: give the solo run
            # the batch's bits by replaying the batch's draws
            solo = peng.predict(
                None if ta is None else _clips(ta, C)[c],
                None if tc is None else _clips(tc, C)[c],
                init_code=int(inits[c]), init_phase=phases[c],
                rng=_replayed_rng(peng, C, c, ta if ta is not None else tc))
            _assert_results_equal(batch[c], solo)


def _replayed_rng(engine, C, c, lead):
    """An rng whose next draws are lane c's rand bits of a C-clip batch
    drawn from RandomState(3) (no_phase mode), else any rng."""
    if not (not engine.cfg.use_phase and engine.cfg.use_aud
            and engine.cfg.use_txt):
        return np.random.RandomState(0)
    Q = lead.shape[0] * lead.shape[1]
    bits = np.random.RandomState(3).rand(Q).reshape(C, -1)[c]

    class _Replay:
        def rand(self, n):
            assert n == bits.size
            return bits
    return _Replay()


def test_predict_bucketed_equals_predict():
    """A 3-window clip padded to the 4-window bucket, and a 5-window clip
    to 8: the same codes, phases and votes as predict (shipped, chaining)
    and codes for a non-chaining preset (mfcc: the padding windows draw
    their re-seeds after the real ones)."""
    for preset in ("shipped", "mfcc"):
        _, peng, ta, tc = _engines(preset, n_test=5)
        for W in (3, 5):
            args = (None if ta is None else ta[:W],
                    None if tc is None else tc[:W])
            want = peng.predict(*args, rng=np.random.RandomState(11))
            got = peng.predict_bucketed(*args, rng=np.random.RandomState(11))
            assert got.codes.shape == (W, 30)
            _assert_results_equal(got, want)


def raw_servers(preset, seed):
    """(rng, JAX RawWavServer, port RawWavServer, samples per window): the
    same small encoder (2-layer WavLM or small vq-wav2vec), VQ-VAE, pose
    statistics and fixture database on both sides."""
    rng, fx, cfg, jdb, pdb, vq = _setup(preset, seed)
    if preset == "shipped":
        torch.manual_seed(3)
        encoder = pw.WavLM(pw.WavLMConfig(**WAVLM_SMALL), device="cpu")
        jenc = jw.WavLMJax(jw.WavLMJaxConfig(scan_layers=False,
                                             **WAVLM_SMALL))
        enc_vars = jw.convert_wavlm(encoder.state_dict(), jenc.cfg)
        n = 2000
    else:
        encoder = _port_vqw2v()
        jenc = jv.VQWav2Vec(jv.VQWav2VecConfig(conv_layers=VQW2V_SMALL))
        _, enc_vars = jv.convert_vq_wav2vec(encoder.state_dict(), jenc.cfg)
        n = 64000
    vq_cfg = VQVAEConfig(input_dim=135, **TINY)
    params, cb = convert_vqvae(vq.state_dict(), vq_cfg)
    mean = rng.randn(135).astype(np.float32)
    std = rng.rand(135).astype(np.float32) + 0.5
    jax_server = JaxRawWavServer(
        jax_engine.CodeKNNEngine(cfg, jdb), JaxVQVAE(vq_cfg), params, cb,
        lambda p, w: jenc.apply(p, w), enc_vars, mean, std)
    server = RawWavServer(port_engine.CodeKNNEngine(port_config(cfg), pdb,
                                                    device="cpu"),
                          vq, encoder, mean, std)
    return rng, jax_server, server, n


@pytest.mark.parametrize("preset", ["wavvq", "shipped"])
def test_serve_batch_matches_jax_and_solo_serve(preset):
    """serve_batch of 2 clips x 2 int16 windows (the contract of the JAX
    package's serve_batch tests): codes equal the JAX serve_batch's and the
    port's solo serve() per clip with the same init codes; poses within
    1e-4 of JAX's (float32 decode, summation order)."""
    rng, jax_server, server, n = raw_servers(preset, 61)
    C, W = 2, 2
    wav = (rng.randn(C, W, n) * 2000).astype(np.int16)
    ctx = rng.randn(C, W, 30, 384).astype(np.float32)
    init_codes = np.array([3, 9], np.int32)
    init_phases = rng.rand(C, 8, 16).astype(np.float32)
    want_codes, want_poses = jax_server.serve_batch(
        wav, ctx, init_codes, init_phases, rng=np.random.RandomState(1))
    codes, poses = server.serve_batch(wav, ctx, init_codes, init_phases,
                                      rng=np.random.RandomState(1))
    assert codes.shape == (C, W, 30) and poses.shape == (C, W * 240, 135)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_allclose(poses, want_poses, rtol=0, atol=1e-4)
    for c in range(C):
        solo_codes, solo_poses = server.serve(
            wav[c], ctx[c], init_code=int(init_codes[c]),
            init_phase=init_phases[c])
        np.testing.assert_array_equal(codes[c], solo_codes)
        np.testing.assert_allclose(poses[c], solo_poses, rtol=0, atol=1e-5)
