"""Headline benchmark of the port on one CUDA card: ``python -m
qpgesture_tpu_torch.cli bench``.

The sections of the JAX package's ``bench.py`` (the repo root) and of its
raw-wav probe ``examples/rawwav_latency.py``, at their shapes and on their
seeded data: a 24 s clip (W=6 windows of 4 s) matched against a
speaker-10-scale database (J=1024 windows) with the full phase + text +
audio CodeKNN semantics, then VQ-VAE-decoded to 135-dim poses, in both
audio modes:

  * wavvq  — edit distance over vq-wav2vec codes (kernel K1); the headline
             ``value`` is its gesture-seconds per wall second;
  * wavlm  — WavLM-feature cosine (the shipped preset).

``np.random.RandomState(0)`` draws the data in the JAX bench's order, so
both benches stage the same database and requests. The weights are random
and seeded: no checkpoint ships, and the compute does not depend on them.

Sections, each emitted as one compact JSON line on stdout when it ends:

  * wavvq / wavlm: e2e p50 / p95 over RUNS requests (``predict_device`` +
    ``VQVAE.decode``, host clock ending in the host copy of codes and
    poses); ``device``: ``device_ms`` (match + decode), ``tables_ms``,
    ``fuse_scan_ms``, ``decode_ms``, analytic ``match_flops`` and (wavvq)
    ``lev_cells`` / ``lev_gcells_per_s``, (wavlm) ``tflops_effective``,
    ``mfu_bf16_peak`` and the tables at cosine precision "high" and
    "default"; ``idle_share``; wavvq also ``batched_16clip``
    (``predict_batch`` of 16 clips);
  * rawwav:<mode> (``QPG_BENCH_RAWWAV_MODES``, default
    ``wavvq,wavlm_split:default``): ``serve.RawWavServer`` from int16 wav
    through vq-wav2vec or WavLM-Large (at the ``:precision`` suffix;
    ``wavlm*:default`` runs K2 in bfloat16, the others in float32): e2e
    p50, ``enc_ms`` / ``match_ms`` / ``decode_ms`` and their sum
    ``device_ms``, the counted ``flops`` and their share of the bfloat16
    peak, the first call's wall;
  * train_vqvae: the VQ-VAE step at ``TrainConfig()`` (batch 256 x 240 x
    135) under the trainer's cuDNN autotune, host p50 and device ms a
    step, counted FLOPs; ``bf16_variant`` at ``conv_precision="default"``;
  * rawpose_knn_batch16: ``GestureKNNEngine.search_motion_batch`` of 16
    sequences against K=16 x L=236 frames;
  * pae_extract: ``PhaseExtractor.pose_to_phase`` over 8192 frames.

What the keys measure. ``*_ms`` under ``device`` and the raw-wav parts are
``utils/devtime.py``'s CUDA-event times, k_small and k_large calls queued
back to back and differenced. The matching scan is a host loop of small
launches, so for every stage that holds it (``device_ms``,
``fuse_scan_ms``, ``match_ms``, the batch) that time includes the gaps
between launches while the card waits for the host: it is the stage's
time on the card's clock, not the card's busy time, which the JAX key of
the same name meant (an XLA program runs without host gaps), and it
varies more from run to run. ``decode_ms`` is the decode timed alone, not
``device_ms`` less the match: the difference of two host-bound times
drowns a ~1 ms decode. Parts timed alone do not overlap, while in a
request the host launches the scan as the card still runs the encoder, so
a raw-wav ``device_ms`` (their sum) can exceed its e2e p50. ``idle_share``
(1 - busy / wall over one request under ``torch.profiler``,
``utils/profiling.device_busy``) says how much of it is idle. ``flops``
counts the operators torch has formulas for (``devtime.
cost_analysis_flops``); it does not see the hand-written kernels K1 and K2,
as XLA's cost analysis did not see the Pallas kernels. The line names the
card (``device_kind``, ``torch.cuda.get_device_name``) and its power limit
(``power_limit``, from ``nvidia-smi``); a card below 700 W runs slower
under load.

Dropped from the JAX bench, and why:

  * the subprocess per raw-wav probe and its timeouts: they isolated stalls
    of a TPU's compile relay; the card has none, and the probes run in
    this process;
  * ``compile_cache_warm``, the ``.jax_cache`` settings and the
    ``compile_s`` keys: nothing here compiles through XLA (K1 and K2 build
    once with ``nvcc``, inside the first call's wall);
  * the fused and split raw-wav programs: the port has one eager path, so
    ``_split`` is accepted and names the entry as the JAX bench names it,
    and both spellings report the three parts; the probe's ``--parity``
    and ``--warm-only`` flags are not part of the bench;
  * rebuilding a snapshot from the tail of a captured output whose head
    was clipped: this bench writes its own lines, and its full detail to
    ``--full-out``;
  * the automatic search for a ``BENCH_r*.json`` snapshot: those are a
    TPU's, not targets. ``--check PATH`` compares with a snapshot of this
    bench and refuses one whose ``device_kind`` names no CUDA card.

The bench runs on the card and raises without one: a CPU run has no device
time. No section is caught and replaced by a note; a section that fails
fails the run. Only the wall-clock budget (``QPG_BENCH_BUDGET_S``, default
2400 s, counted from the start of the run, not from the import) records
sections it had no time for under ``skipped``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from .core import constants as C
from .core.config import (MATCH_PRESETS, PAEConfig, TrainConfig,
                          VQVAEConfig)
from .core.schemas import CodebookSignature, DatabaseBundle
from .match.database import (stage_database, stage_test_audio,
                             stage_test_context)
from .match.engine import (CodeKNNEngine, _solo_resets, _tables_impl,
                           device_match_db)
from .match.gesture_knn import GestureKNNData, GestureKNNEngine
from .models.pae import PAE, PhaseExtractor
from .models.vq_wav2vec import VQWav2Vec
from .models.vqvae import VQVAE
from .models.wavlm import PRECISIONS, WavLM, WavLMConfig
from .serve import RawWavServer
from .train.train_vqvae import VQVAETrainer, seeded_init
from .utils import devtime
from .utils.profiling import device_busy

RUNS = 9
BASELINE = 24.0 / 300.0  # reference: ~5 min for the 24 s quick-start
J = 1024                 # speaker-10-scale database (4 s windows)
W = 6                    # 24 s test clip
N_SAMPLES = 64000        # one 4 s window at 16 kHz
PAE_FRAMES = 8192        # one recording through the PAE
INIT_CODE = 7
# Every section runs here. A rehearsal of the sections on the CPU sets it to
# "cpu" (with devtime's timers stubbed: the CPU has no device time); run()
# refuses to measure anything but a card.
DEVICE = "cuda"
DEFAULT_RAWWAV_MODES = "wavvq,wavlm_split:default"
FULL_OUT = "bench_torch_full.json"
METRIC = "gesture_seconds_matched_per_wall_second"
# Words in the names torch.cuda.get_device_name gives NVIDIA's cards.
_CUDA_KIND = re.compile(r"NVIDIA|Tesla|GeForce|Quadro|RTX|TITAN")


def _build_common(rng, J):
    bundle = DatabaseBundle(
        context=rng.randn(J, 30, C.CONTEXT_DIM).astype(np.float32),
        phase=rng.rand(J, C.NUM_FRAMES, 4, 8).astype(np.float32))
    codes = rng.randint(0, C.CODEBOOK_SIZE, size=(J, 30)).astype(np.int32)
    signature = CodebookSignature(
        code=np.tile(np.arange(C.CODEBOOK_SIZE)[:, None], (1, 30)),
        poses=np.zeros((C.CODEBOOK_SIZE, 1, 1), np.float32),
        signature=rng.randn(C.CODEBOOK_SIZE, C.POSE_DIM).astype(np.float32))
    return bundle, codes, signature


def _match_flops(cfg, db, W, S):
    """Analytic per-clip compute of the candidate-table phase.

    cosine modes: 2*Q*N*D matmul FLOPs; wavvq: Q*N*L^2 edit-distance DP
    cells (integer work, no tensor-core FLOPs). Text side is always cosine.
    Returns (flops, lev_cells)."""
    Q = W * S
    flops = 0.0
    cells = 0.0
    if cfg.use_aud:
        J, B = db.aud_codes.shape
        if cfg.audio_mode == "wavvq_feat":
            L = db.aud_strings.shape[-1]
            groups = db.aud_strings.shape[2] if db.aud_strings.ndim == 4 \
                else 1
            cells = float(Q) * J * B * L * L * groups
        else:
            D = db.aud_feat.shape[-1]
            flops += 2.0 * Q * J * B * D
    if cfg.use_txt:
        Jt, St = db.txt_codes.shape
        D = db.txt_feat.shape[-1]
        flops += 2.0 * Q * Jt * St * D
    return flops, cells


def randn_f32(rng, *shape, rows: int = 256) -> np.ndarray:
    """``rng.randn(*shape).astype(np.float32)``, drawn ``rows`` slices of
    the first axis at a time: the legacy generator's successive calls
    continue one stream, so the values are the same, without the whole
    float64 array (twice the float32 result) on the host at once."""
    out = np.empty(shape, np.float32)
    for s in range(0, shape[0], rows):
        n = min(rows, shape[0] - s)
        out[s:s + n] = rng.randn(n, *shape[1:])
    return out


def _draw_mode(mode, rng, J, W):
    """(database audio, test audio, test context) host arrays of the mode,
    drawn from ``rng`` as the JAX bench draws them."""
    if mode == "wavvq":
        audio = rng.randint(0, C.WAVVQ_VOCAB,
                            size=(J, C.WAVVQ_FRAMES, 2)).astype(np.int32)
        test_audio = rng.randint(0, C.WAVVQ_VOCAB,
                                 size=(W, C.WAVVQ_FRAMES, 2)).astype(np.int32)
    else:
        audio = randn_f32(rng, J, C.WAVLM_FRAMES, 1024)
        test_audio = randn_f32(rng, W, C.WAVLM_FRAMES, 1024)
    return audio, test_audio, randn_f32(rng, W, 30, C.CONTEXT_DIM)


def _stage_host(mode, bundle, codes, signature, draws,
                feat_dtype: str = "float32"):
    """The mode's preset, host-staged database and staged test queries of
    ``_draw_mode``'s arrays."""
    audio, test_audio, test_context = draws
    if mode == "wavvq":
        cfg = MATCH_PRESETS["wavvq"]
        db = stage_database(cfg, bundle, codes, signature, wavvq=audio)
        ta = stage_test_audio(cfg, db, wavvq=test_audio)
    else:
        cfg = dataclasses.replace(MATCH_PRESETS["shipped"],
                                  feat_dtype=feat_dtype)
        db = stage_database(cfg, bundle, codes, signature, wavlm=audio)
        ta = stage_test_audio(cfg, db, wavlm=test_audio)
    return cfg, db, ta, stage_test_context(db, test_context)


def _stage_mode(mode, rng, J, W, bundle, codes, signature,
                feat_dtype: str = "float32", device=None):
    """The mode's preset, staged database, engine on ``device`` and staged
    test queries, drawn from ``rng`` as the JAX bench draws them."""
    cfg, db, test_audio, test_ctx = _stage_host(
        mode, bundle, codes, signature, _draw_mode(mode, rng, J, W),
        feat_dtype)
    engine = CodeKNNEngine(cfg, db, device=device or DEVICE)
    return cfg, db, engine, test_audio, test_ctx


def _scan_inputs(engine, W, S):
    """The rand bits and resets predict_device gives one clip that starts
    from INIT_CODE and the zero phase, with the config's seed."""
    rand_bits, reset = engine._chain_inputs(
        W, S, np.random.RandomState(engine.cfg.seed))
    return rand_bits, _solo_resets(W * S, INIT_CODE,
                                   np.zeros((8, 16), np.float32), *reset)


def _clip_codes(cfg, blocks, W, S):
    return blocks.reshape(W, S * cfg.step_sz)[:, :cfg.num_frames_code]


def _host_seconds(fn, n):
    """(p50, p95) host seconds of n calls of fn, each ending in a host
    copy or a synchronise."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.percentile(times, 50)), float(np.percentile(times, 95))


def _bench_mode(mode, rng, J, W, bundle, codes, signature, model, peak):
    """One audio mode: e2e serving latency + the device breakdown."""
    cfg, db, engine, test_audio, test_ctx = _stage_mode(
        mode, rng, J, W, bundle, codes, signature)
    S = test_audio.shape[1]
    zero_phase = np.zeros((8, 16), np.float32)

    def run():
        codes_d, _, _, _ = engine.predict_device(
            test_audio, test_ctx, init_code=INIT_CODE, init_phase=zero_phase)
        poses_d = model.decode(codes_d)
        return codes_d.cpu().numpy(), poses_d.cpu().numpy()

    codes_out, poses = run()  # warm-up: builds the kernels on first use
    if codes_out.shape != (W, 30) or poses.shape != (W, 240, C.POSE_DIM) \
            or not np.isfinite(poses).all():
        raise RuntimeError(f"{mode}: codes {codes_out.shape}, poses "
                           f"{poses.shape} (finite: "
                           f"{bool(np.isfinite(poses).all())})")
    p50, p95 = _host_seconds(run, RUNS)
    busy_s, wall_s, _ = device_busy(run)
    gest_s = W * 4.0
    out = {
        "gest_s_per_s": round(gest_s / p50, 3),
        "p50_ms": round(p50 * 1e3, 2),
        "p95_ms": round(p95 * 1e3, 2),
        "vs_baseline": round(gest_s / p50 / BASELINE, 1),
        "codes": codes_out.tolist(),
    }

    # ---- device: match (tables + scan) + decode, match, tables ----
    ta, tc = engine.stage_queries(test_audio, test_ctx)
    rand_bits, resets = _scan_inputs(engine, W, S)

    def fn_tables():
        return engine.tables(ta, tc)

    def fn_predict():
        return engine.scan(engine.tables(ta, tc), S, 1, rand_bits, resets)[0]

    def fn_full():
        blocks = fn_predict()
        return model.decode(_clip_codes(cfg, blocks, W, S).reshape(1, -1))

    code_string = _clip_codes(cfg, fn_predict(), W, S).reshape(1, -1)
    dev_s, _ = devtime.device_seconds_per_iter(fn_full, k_small=2,
                                               k_large=8, reps=7)
    pred_s, _ = devtime.device_seconds_per_iter(fn_predict, k_small=2,
                                                k_large=8, reps=7)
    tab_s, _ = devtime.device_seconds_per_iter(fn_tables, k_small=2,
                                               k_large=8, reps=7)
    # the decode alone: ~1 ms, below the spread of the host-bound match,
    # so not the difference of the two as the JAX bench takes it
    dec_s, _ = devtime.device_seconds_per_iter(
        lambda: model.decode(code_string), k_small=2, k_large=8, reps=7)

    flops, cells = _match_flops(cfg, db, W, S)
    devd = {
        "device_ms": round(dev_s * 1e3, 3),
        "tables_ms": round(tab_s * 1e3, 3),
        "fuse_scan_ms": round(max(pred_s - tab_s, 0.0) * 1e3, 3),
        "decode_ms": round(dec_s * 1e3, 3),
        "gest_s_per_device_s": round(gest_s / dev_s, 1) if dev_s > 0
        else None,
        "match_flops": flops,
        "idle_share": round(1.0 - busy_s / wall_s, 4),
    }
    if cells:
        devd["lev_cells"] = cells
        if tab_s > 0:
            devd["lev_gcells_per_s"] = round(cells / tab_s / 1e9, 2)
    if flops and tab_s > 0:
        devd["tflops_effective"] = round(flops / tab_s / 1e12, 3)
        u = devtime.mfu(flops, tab_s, peak)
        if u is not None:
            devd["mfu_bf16_peak"] = round(u, 4)
    out["device"] = devd

    if mode == "wavlm":
        # the candidate tables at the opt-in cosine precisions
        # (MatchConfig.cosine_precision): each stages its own database (the
        # bf16 split of the normalized features), so one at a time
        for prec in ("high", "default"):
            cfg_v = dataclasses.replace(cfg, cosine_precision=prec)
            devdb_v = device_match_db(cfg_v, db, engine.device)
            tab_v, _ = devtime.device_seconds_per_iter(
                lambda: _tables_impl(cfg_v, devdb_v, ta, tc), k_small=2,
                k_large=8, reps=5)
            del devdb_v
            if tab_v > 0:
                devd[f"tables_ms_{prec}"] = round(tab_v * 1e3, 3)

    if mode == "wavvq":
        # batched serving: 16 independent 24 s clips as 16 lanes of one
        # scan (seed chains reset at clip boundaries) — the throughput
        # number for production serving, where one clip is host bound
        n_clips = 16
        clip_audio = np.broadcast_to(
            test_audio, (n_clips,) + test_audio.shape).copy()
        clip_ctx = np.broadcast_to(
            test_ctx, (n_clips,) + test_ctx.shape).copy()
        init_codes = np.full((n_clips,), INIT_CODE, np.int32)
        init_phases = np.zeros((n_clips, 8, 16), np.float32)

        def batch():
            return engine.predict_batch(clip_audio, clip_ctx, init_codes,
                                        init_phases)

        batch()  # warm-up
        bp50, _ = _host_seconds(batch, max(3, RUNS // 3))
        batch_gest_s = n_clips * W * 4.0

        Q = n_clips * W * S
        reset_mask = np.zeros((Q,), bool)
        reset_mask[::W * S] = True
        batch_resets = (reset_mask, np.full((Q,), INIT_CODE, np.int64),
                        np.zeros((Q, 8, 16), np.float32))
        bta, btc = engine.stage_queries(
            clip_audio.reshape((n_clips * W,) + clip_audio.shape[2:]),
            clip_ctx.reshape((n_clips * W,) + clip_ctx.shape[2:]))

        def fn_batch():
            return engine.scan(engine.tables(bta, btc), S, n_clips, None,
                               batch_resets)[0]

        bdev_s, _ = devtime.device_seconds_per_iter(fn_batch, k_small=1,
                                                    k_large=4, reps=5)
        out["batched_16clip"] = {
            "gest_s_per_s": round(batch_gest_s / bp50, 1),
            "p50_ms": round(bp50 * 1e3, 2),
            "vs_baseline": round(batch_gest_s / bp50 / BASELINE, 1),
            "device_ms": round(bdev_s * 1e3, 2),
            "gest_s_per_device_s": round(batch_gest_s / bdev_s, 1)
            if bdev_s > 0 else None,
        }
    return out


def _decoder(rng, device=None):
    """The full-size VQ-VAE (seed 0) on ``device`` (None: DEVICE), its
    codebook initialised from two random windows drawn from ``rng`` (the
    restarts' own draws from a generator of seed 1, so that ``rng``
    advances as the JAX bench's)."""
    device = device or DEVICE
    model = seeded_init(lambda: VQVAE(VQVAEConfig(), device="cpu"), 0)
    model.to(device)
    x = torch.as_tensor(rng.randn(2, 240, C.POSE_DIM).astype(np.float32),
                        device=device)
    model.init_codebook_from_batch(x, np.random.RandomState(1))
    return model


def _rawwav_mode(mode: str):
    """'wavvq' | 'wavlm' [+ '_split'] [+ ':highest|high|default'] ->
    (base, WavLM precision)."""
    name, _, precision = mode.partition(":")
    base = name[:-len("_split")] if name.endswith("_split") else name
    if base not in ("wavvq", "wavlm") or (
            precision and (base == "wavvq" or precision not in PRECISIONS)):
        raise ValueError(f"raw-wav mode {mode!r}: expected wavvq or "
                         f"wavlm[_split][:{'|'.join(PRECISIONS)}]")
    return base, precision or "highest"


def _encoder(base, precision, device=None):
    """The full-size audio encoder (random weights, seed 7) on ``device``
    (None: DEVICE): vq-wav2vec for wavvq, WavLM-Large at ``precision`` for
    wavlm."""
    device = device or DEVICE
    if base == "wavvq":
        return seeded_init(lambda: VQWav2Vec(device="cpu"), 7).to(device)
    cfg = WavLMConfig(precision=precision)
    return seeded_init(lambda: WavLM(cfg, device="cpu"), 7).to(device)


def _rawwav_setup(mode, rng, J, W, device=None):
    """(cfg, engine, model, server) of a raw-wav mode, drawn from ``rng``
    as examples/rawwav_latency.py draws them."""
    base, precision = _rawwav_mode(mode)
    bundle, codes, signature = _build_common(rng, J)
    cfg, _, engine, _, _ = _stage_mode(base, rng, J, W, bundle, codes,
                                       signature, device=device)
    model = _decoder(rng, device)
    server = RawWavServer(engine, model, _encoder(base, precision, device))
    return cfg, engine, model, server


def _rawwav_device(cfg, engine, model, server, wav, ctx, W):
    """Device seconds of the encoder (with device staging), the match and
    the decode of one request, each timed alone, and the counted FLOPs of
    the three."""
    S = server.n_steps
    wav_d = torch.as_tensor(wav, device=engine.device)
    ctx_d = torch.as_tensor(ctx, device=engine.device)
    rand_bits, resets = _scan_inputs(engine, W, S)

    def fn_enc():
        return server.stage(server.encode(wav_d), ctx_d)

    ta, tc = fn_enc()

    def fn_match():
        return engine.scan(engine.tables(ta, tc), S, 1, rand_bits, resets)[0]

    code_string = _clip_codes(cfg, fn_match(), W, S).reshape(1, -1)

    def fn_dec():
        return model.decode(code_string)

    enc_s, _ = devtime.device_seconds_per_iter(fn_enc, k_small=1, k_large=3,
                                               reps=5)
    match_s, _ = devtime.device_seconds_per_iter(fn_match, k_small=1,
                                                 k_large=3, reps=5)
    dec_s, _ = devtime.device_seconds_per_iter(fn_dec, k_small=1, k_large=3,
                                               reps=5)
    flops = sum(devtime.cost_analysis_flops(fn)[0]
                for fn in (fn_enc, fn_match, fn_dec)) or None
    return enc_s, match_s, dec_s, flops


def _bench_rawwav(mode, peak):
    """Raw 16 kHz int16 windows -> poses through serve.RawWavServer (the
    ingress the reference's quick-start leaves out), on the data
    examples/rawwav_latency.py stages: its own RandomState(0)."""
    rng = np.random.RandomState(0)
    cfg, engine, model, server = _rawwav_setup(mode, rng, J, W)
    wav = (rng.randn(W, N_SAMPLES) * 3000).astype(np.int16)
    ctx = rng.randn(W, 30, C.CONTEXT_DIM).astype(np.float32)

    t0 = time.perf_counter()
    codes_out, poses = server.serve(wav, ctx, init_code=INIT_CODE)
    first_call_s = time.perf_counter() - t0
    if codes_out.shape != (W, 30) or poses.shape != (W * 240, C.POSE_DIM) \
            or not np.isfinite(poses).all():
        raise RuntimeError(f"rawwav:{mode}: codes {codes_out.shape}, poses "
                           f"{poses.shape}")
    p50, _ = _host_seconds(lambda: server.serve(wav, ctx, init_code=INIT_CODE),
                         7)

    # device: encoder + device staging, match, decode, each alone
    enc_s, match_s, dec_s, flops = _rawwav_device(cfg, engine, model,
                                                  server, wav, ctx, W)
    dev_s = enc_s + match_s + dec_s
    gest_s = W * 4.0
    out = {
        "mode": mode,
        "e2e_p50_ms": round(p50 * 1e3, 2),
        "device_ms": round(dev_s * 1e3, 2),
        "enc_ms": round(enc_s * 1e3, 2),
        "match_ms": round(match_s * 1e3, 2),
        "decode_ms": round(dec_s * 1e3, 2),
        "gest_s_per_s": round(gest_s / p50, 1),
        "gest_s_per_device_s": round(gest_s / dev_s, 1) if dev_s > 0
        else None,
        "first_call_wall_s": round(first_call_s, 1),
        "flops": flops,
    }
    if flops and dev_s > 0:
        out["tflops_effective"] = round(flops / dev_s / 1e12, 2)
        u = devtime.mfu(flops, dev_s, peak)
        if u is not None:
            out["mfu_bf16_peak"] = round(u, 4)
    return out


def _trainer(model_cfg, cfg, batch):
    trainer = VQVAETrainer(model_cfg, cfg, device=DEVICE, seed=0)
    trainer.init_codebook(batch[:16])
    return trainer


def _step_seconds(trainer, batch):
    """Device seconds a step: devtime's chained timing, each step's loss
    the carry."""
    return devtime.chained_seconds_per_iter(
        lambda _, b: trainer.train_step(b), None, (batch,), k_small=1,
        k_large=4, reps=5)[0]


def _bench_train(rng, peak):
    """VQ-VAE training-step throughput at the reference envelope (batch 256
    of 240x135 windows, codebook.yml:35-49): host p50 of single steps, each
    ending in the loss's host copy, and device ms a step; FLOPs counted by
    torch's operator formulas."""
    cfg = TrainConfig()
    batch = torch.as_tensor(
        rng.randn(cfg.batch_size, cfg.n_poses, C.POSE_DIM)
        .astype(np.float32), device=DEVICE)
    trainer = _trainer(VQVAEConfig(), cfg, batch)
    trainer.train_step(batch)[0].item()  # warm-up: cuDNN times its kernels
    p50, _ = _host_seconds(lambda: trainer.train_step(batch)[0].item(), RUNS)
    flops, _ = devtime.cost_analysis_flops(trainer.train_step, batch)
    dev_s = _step_seconds(trainer, batch)
    out = {"step_ms_p50": round(p50 * 1e3, 2),
           "windows_per_s": round(cfg.batch_size / p50, 1),
           "device_ms_per_step": round(dev_s * 1e3, 2),
           "windows_per_device_s": round(cfg.batch_size / dev_s, 1)
           if dev_s > 0 else None,
           "flops_per_step": flops}
    if dev_s > 0:
        out["tflops_effective"] = round(flops / dev_s / 1e12, 2)
        u = devtime.mfu(flops, dev_s, peak)
        if u is not None:
            out["mfu_bf16_peak"] = round(u, 4)
    del trainer
    torch.cuda.empty_cache()

    # conv_precision "default": bfloat16 operands, float32 sums — the
    # opt-in fast path; the float32 default above runs true float32
    trainer_b = _trainer(VQVAEConfig(conv_precision="default"), cfg, batch)
    dev_b = _step_seconds(trainer_b, batch)
    if dev_b > 0:
        out["bf16_variant"] = {
            "device_ms_per_step": round(dev_b * 1e3, 2),
            "windows_per_device_s": round(cfg.batch_size / dev_b, 1)}
        u = devtime.mfu(flops, dev_b, peak)
        if u is not None:
            out["bf16_variant"]["mfu_bf16_peak"] = round(u, 4)
    del trainer_b
    torch.cuda.empty_cache()
    return out


def _bench_rawpose(rng):
    """Raw-pose GestureKNN batched search (the reference's 1h58m/185-seq
    workload shape, GestureKNN.py:410): C=16 4 s test sequences against a
    16x236-frame database, the lanes of one host loop."""
    K, L, A, P = 16, 236, 78, 180
    n_seqs, n_frames = 16, 240
    db = GestureKNNData(
        feat=rng.randn(K, L, A + P).astype(np.float32),
        motion=rng.randn(K, L, C.POSE_DIM).astype(np.float32),
        control_mask=np.ones((K, L)), n_aud=A)
    engine = GestureKNNEngine(db, device=DEVICE)
    feat_tests = rng.randn(n_seqs, A, n_frames).astype(np.float32)
    seqs = np.zeros((n_seqs,), np.int64)
    frms = np.full((n_seqs,), 5, np.int64)

    def search():
        return engine.search_motion_batch(feat_tests, seqs, frms)

    out = search()  # warm-up; host arrays come back
    if out.shape != (n_seqs, C.POSE_DIM, n_frames) or \
            not np.isfinite(out).all():
        raise RuntimeError(f"rawpose: motion {out.shape}")
    p50, _ = _host_seconds(search, 5)
    gest_s = n_seqs * n_frames / 60.0
    return {"p50_ms": round(p50 * 1e3, 2),
            "gest_s_per_s": round(gest_s / p50, 1),
            "n_seqs": n_seqs}


def _bench_pae(rng):
    """PAE phase extraction: stride-1 sliding-window encode of a whole
    recording (pose2phase, PAE.py:477-508; the reference runs it one window
    at a time at batch 1)."""
    cfg = PAEConfig()
    ex = PhaseExtractor(seeded_init(lambda: PAE(cfg, device="cpu"), 0),
                        device=DEVICE)
    T = PAE_FRAMES
    pose = rng.randn(T, cfg.input_channels).astype(np.float32)
    mean = np.zeros(C.POSE_DIM, np.float32)
    std = np.ones(C.POSE_DIM, np.float32)
    out = ex.pose_to_phase(pose, mean, std)  # warm-up; host arrays
    if out.shape != (T, 4, cfg.phase_channels) or not np.isfinite(out).all():
        raise RuntimeError(f"pae: phases {out.shape}")
    p50, _ = _host_seconds(lambda: ex.pose_to_phase(pose, mean, std), 3)
    return {"frames": T, "p50_ms": round(p50 * 1e3, 2),
            "frames_per_s": round(T / p50, 1)}


# ---- the card, the budget and the emission --------------------------------

def _card():
    """(device kind, bfloat16 peak FLOP/s, launch floor in s, power limit):
    raises without a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench measures the card, and torch.cuda."
                           "is_available() is False: a CPU run has no "
                           "device time")
    kind, peak = devtime.peak_flops_per_s("bfloat16", 0)
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    return kind, peak, devtime.measure_link_s(), power


def _compact_device(dev: dict) -> dict:
    keys = ("device_ms", "tables_ms", "fuse_scan_ms", "decode_ms",
            "lev_gcells_per_s", "tflops_effective", "mfu_bf16_peak",
            "tables_ms_high", "tables_ms_default", "idle_share")
    return {k: dev[k] for k in keys if k in dev}


def _compact_mode(sec: dict) -> dict:
    out = {k: sec[k] for k in ("gest_s_per_s", "p50_ms", "vs_baseline")
           if k in sec}
    if "device" in sec:
        out["device"] = _compact_device(sec["device"])
    if "batched_16clip" in sec:
        b = sec["batched_16clip"]
        out["batched_16clip"] = {
            k: b[k] for k in ("gest_s_per_s", "device_ms",
                              "gest_s_per_device_s") if k in b}
    return out


def _compact_rawwav(sec: dict) -> dict:
    keys = ("e2e_p50_ms", "device_ms", "enc_ms", "match_ms",
            "gest_s_per_s", "mfu_bf16_peak")
    return {k: sec[k] for k in keys if k in sec}


def _compact_train(sec: dict) -> dict:
    out = {k: sec[k] for k in ("step_ms_p50", "device_ms_per_step",
                               "windows_per_device_s", "mfu_bf16_peak")
           if k in sec}
    bf = sec.get("bf16_variant")
    if bf:
        out["bf16_variant"] = {k: bf[k] for k in (
            "device_ms_per_step", "windows_per_device_s", "mfu_bf16_peak")
            if k in bf}
    return out


def _compact(full: dict) -> dict:
    """The one-line snapshot of the full-detail dict: the same nesting
    along the regression keys' paths, without the detail."""
    compact = {k: full[k] for k in (
        "metric", "value", "unit", "vs_baseline", "runs", "device_kind",
        "power_limit", "peak_bf16_tflops", "link_ms") if k in full}
    for mode in ("wavvq", "wavlm"):
        if mode in full:
            compact[mode] = _compact_mode(full[mode])
    if "rawwav" in full:
        compact["rawwav"] = {m: _compact_rawwav(s)
                             for m, s in full["rawwav"].items()}
    if "train_vqvae" in full:
        compact["train_vqvae"] = _compact_train(full["train_vqvae"])
    for k in ("rawpose_knn_batch16", "pae_extract", "pending", "skipped",
              "checked_against", "regressions", "elapsed_s"):
        if full.get(k) is not None:
            compact[k] = full[k]
    return compact


def _emit(full: dict, path: str) -> dict:
    """Write the full-detail dict to ``path`` and print its compact
    snapshot as one line on stdout. Returns the compact dict."""
    with open(path, "w") as f:
        json.dump(full, f, indent=1)
    compact = _compact(full)
    print(json.dumps(compact), flush=True)
    return compact


# The budget's clock (a test substitutes its own).
_clock = time.monotonic


class _Budget:
    """The run's wall-clock budget over its sections: ``begin`` records a
    section it has no time for under ``skipped``; ``done`` takes a section
    off ``pending`` and emits the record."""

    def __init__(self, out: dict, budget_s: float, full_out: str):
        self.out, self.budget_s, self.full_out = out, budget_s, full_out
        self.t0 = _clock()

    def elapsed(self) -> float:
        return _clock() - self.t0

    def begin(self, name: str, reserve_s: float) -> bool:
        if self.budget_s - self.elapsed() < reserve_s:
            self.out["skipped"].append(name)
            self.out["pending"].remove(name)
            print(f"budget exhausted ({self.elapsed():.0f}s elapsed) — "
                  f"skipping {name}", file=sys.stderr)
            return False
        print(f"benchmarking {name}... ("
              f"{self.budget_s - self.elapsed():.0f}s budget left)",
              file=sys.stderr)
        return True

    def done(self, name: str) -> None:
        self.out["pending"].remove(name)
        self.out["elapsed_s"] = round(self.elapsed(), 1)
        _emit(self.out, self.full_out)


# ---- regression guard: `bench --check SNAPSHOT` exits 1 when a device-time
# metric regresses more than REGRESSION_FACTOR against the snapshot ---------

REGRESSION_FACTOR = float(os.environ.get("QPG_BENCH_CHECK_FACTOR", "1.2"))

_REGRESSION_KEYS = (
    ("wavvq.device.device_ms", ("wavvq", "device", "device_ms")),
    ("wavvq.device.tables_ms", ("wavvq", "device", "tables_ms")),
    ("wavvq.device.fuse_scan_ms", ("wavvq", "device", "fuse_scan_ms")),
    ("wavlm.device.device_ms", ("wavlm", "device", "device_ms")),
    ("wavlm.device.tables_ms", ("wavlm", "device", "tables_ms")),
    ("rawwav.wavvq.device_ms", ("rawwav", "wavvq", "device_ms")),
    # a mode a run did not ask for has no row: _dig gives None on that
    # side and the check skips the key
    ("rawwav.wavlm_split.device_ms",
     ("rawwav", "wavlm_split", "device_ms")),
    ("rawwav.wavlm_split:high.device_ms",
     ("rawwav", "wavlm_split:high", "device_ms")),
    ("rawwav.wavlm_split:default.device_ms",
     ("rawwav", "wavlm_split:default", "device_ms")),
    ("train_vqvae.device_ms_per_step",
     ("train_vqvae", "device_ms_per_step")),
)


def _dig(d, path):
    for k in path:
        if not isinstance(d, dict) or k not in d:
            return None
        d = d[k]
    return d if isinstance(d, (int, float)) else None


def load_snapshot(path: str) -> dict:
    """A snapshot of this bench: its compact line or its full file (an
    object with "metric"), or a wrapper holding one under "parsed" or as
    the last such line of a "tail" of output. Raises ValueError for any
    other content and for a snapshot whose ``device_kind`` names no CUDA
    card: a TPU's numbers are no target for the card."""
    with open(path) as f:
        obj = json.load(f)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: not a bench snapshot")
    if "metric" not in obj:
        tail = str(obj.get("tail", ""))
        start = tail.rfind('{"metric"')
        if obj.get("parsed"):
            obj = obj["parsed"]
        elif start >= 0:
            obj = json.loads(tail[start:].splitlines()[0])
        else:
            raise ValueError(f"{path}: no bench JSON found")
    kind = str(obj.get("device_kind"))
    if not _CUDA_KIND.search(kind):
        raise ValueError(f"{path}: device_kind {kind!r} names no CUDA card; "
                         f"only a snapshot of this bench on a card is a "
                         f"target")
    return obj


def check_regressions(current: dict, snapshot: dict,
                      factor: float = None) -> list:
    factor = factor or REGRESSION_FACTOR
    bad = []
    for name, path in _REGRESSION_KEYS:
        ref = _dig(snapshot, path)
        cur = _dig(current, path)
        if ref is None or cur is None or ref <= 0:
            continue
        if cur > ref * factor:
            bad.append(f"{name}: {cur:.3f} ms vs snapshot {ref:.3f} ms "
                       f"(>{factor:.2f}x)")
    return bad


def add_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--full-out", default=FULL_OUT,
                   help=f"file for the full detail (default {FULL_OUT} in "
                        f"the working directory)")
    p.add_argument("--check", metavar="SNAPSHOT",
                   help="a snapshot of this bench on a card: exit 1 when a "
                        "device time regresses past QPG_BENCH_CHECK_FACTOR "
                        "(1.2), 2 when the snapshot is missing, unparseable "
                        "or not a card's")


def run(args: argparse.Namespace) -> dict:
    """The bench with parsed arguments; returns the full-detail dict."""
    budget_s = float(os.environ.get("QPG_BENCH_BUDGET_S", "2400"))
    rawwav_modes = [m for m in os.environ.get(
        "QPG_BENCH_RAWWAV_MODES", DEFAULT_RAWWAV_MODES).split(",") if m]
    for m in rawwav_modes:
        _rawwav_mode(m)
    snapshot = None
    if args.check:
        try:
            snapshot = load_snapshot(args.check)
        except (OSError, ValueError) as e:
            print(f"regression check: {args.check}: {e}", file=sys.stderr)
            raise SystemExit(2)

    out = {"metric": METRIC, "value": None, "unit": "gesture-s/s",
           "vs_baseline": None, "pending": ["setup"]}
    budget = _Budget(out, budget_s, args.full_out)
    kind, peak, link_s, power = _card()
    _emit(out, args.full_out)  # a parseable line before the set-up

    rng = np.random.RandomState(0)
    bundle, codes, signature = _build_common(rng, J)
    model = _decoder(rng)
    sections = ["wavvq", "wavlm", "train_vqvae", "rawpose_knn_batch16",
                "pae_extract"] + [f"rawwav:{m}" for m in rawwav_modes]
    out.update({
        "runs": RUNS,
        "device_kind": kind,
        "power_limit": power,
        "peak_bf16_tflops": round(peak / 1e12, 1) if peak else None,
        "link_ms": round(link_s * 1e3, 4),
        "skipped": [],
        "pending": list(sections),
    })

    def rawwav(mode):
        name = f"rawwav:{mode}"
        if budget.begin(name, reserve_s=120):
            out.setdefault("rawwav", {})[mode] = _bench_rawwav(mode, peak)
            budget.done(name)

    for mode in ("wavvq", "wavlm"):
        if budget.begin(mode, reserve_s=60):
            out[mode] = _bench_mode(mode, rng, J, W, bundle, codes,
                                    signature, model, peak)
            if mode == "wavvq":
                out["value"] = out[mode]["gest_s_per_s"]
                out["vs_baseline"] = out[mode]["vs_baseline"]
            budget.done(mode)
    # the flagship raw-wav mode right after the core modes, the rest last
    if rawwav_modes:
        rawwav(rawwav_modes[0])
    if budget.begin("train_vqvae", reserve_s=90):
        out["train_vqvae"] = _bench_train(rng, peak)
        budget.done("train_vqvae")
    if budget.begin("rawpose_knn_batch16", reserve_s=60):
        out["rawpose_knn_batch16"] = _bench_rawpose(rng)
        budget.done("rawpose_knn_batch16")
    if budget.begin("pae_extract", reserve_s=60):
        out["pae_extract"] = _bench_pae(rng)
        budget.done("pae_extract")
    for mode in rawwav_modes[1:]:
        rawwav(mode)

    if snapshot is not None:
        out["checked_against"] = os.path.basename(args.check)
        out["regressions"] = check_regressions(out, snapshot)
        for line in out["regressions"]:
            print(f"REGRESSION: {line}", file=sys.stderr)
    out["elapsed_s"] = round(budget.elapsed(), 1)
    for k in ("skipped", "pending"):
        if not out[k]:
            del out[k]
    _emit(out, args.full_out)
    if out.get("regressions"):
        raise SystemExit(1)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="bench", description="Headline benchmark of the port on one "
        "CUDA card: one compact JSON line per section on stdout, the full "
        "detail in --full-out.")
    add_arguments(p)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    main()
