#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds every CUDA kernel of the port from the sources in the checkout (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version on the card, and drives the port's paths, each with the kernel
counts set to 0 just before it and read just after:

  phases 3-5   K1 checks and times; host-staged wavvq serving (J=1024
               database, 3 requests of 6 windows = 24 s clips) and the
               match -> decode CLI (a J=64 database on disk);
  phase 6      K2 in float32 and bfloat16 against its plain version at
               its tile edges, hd 16/32/64; K2 / plain / SDPA times in
               both types (and K2 / SDPA at serve_batch's B=24);
  phase 7      raw-wav serving of the shipped preset at full WavLM-Large
               width (24 layers, random weights), 3 requests of 6 int16
               windows, against host-staged serving, the eager attention
               and the CPU port;
  phase 8      the same requests with the encoder at precision="default":
               bfloat16 K2, codes against host-staged serving and phase
               7's, features against the CPU port's "default";
  phase 9      raw-wav serving of the wavvq preset (random vq-wav2vec);
  phase 10     the ``generate`` CLI, wav file -> BVH (a 2-layer WavLM);
  phase 11     batched serving: predict_batch of 8 staged wavvq clips (the
               lane-batched fusion scan) against solo predict, and
               RawWavServer.serve_batch of 4 shipped clips (24 windows in
               one WavLM-Large batch) against predict_batch over host
               staging of the card's batched features;
  phase 12     streaming: StreamingPool (8 wavvq streams) and
               StreamingRawWavPool (4 shipped streams), 6 ticks each,
               against solo sessions; idle streams, reset_stream, and a
               tick and a push under torch's sync debug mode "error";
  phase 13     phase 7's requests with the encoder at precision="high"
               (bf16x3 GEMMs, float32 K2);
  phase 14     transcript ingress: a full-width random MiniLM through
               torch.save and load_minilm, TranscriptContextStager's
               context feeding RawWavServer.serve;
  phase 15     database build -> serve: four 60 s BEAT-like recordings
               (BVH, wav, transcript) through process_recording, the
               full-width PAE's PhaseExtractor, window_recordings with
               MiniLM context, encode_windows, codebook_signature,
               extract_wavlm (WavLM-Large, K2 f32 at B=8) and
               extract_wavvq, each held against the CPU port; the built
               database served (shipped: K2, wavvq: K1) against the CPU
               port's engine; then the build-db, phase, signature,
               test-audio, assemble-beat and warmup CLIs, their files held
               against the library calls.

It prints one line per check. The last three lines are the card's name and
power limit, one JSON object with every kernel's launches, error and
times, and ``{"ok": true, "device": {...}}``. Any failure exits nonzero
before that last line; so does a machine without a CUDA device, and a
directory that holds this script without the package.

Imports nothing of JAX: the card's machine runs the port alone.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20260
J = 1024           # database sequences (tests/fixtures.py shapes)
W = 6              # windows per request: a 24 s clip
N_REQUESTS = 3
J_CLI = 64         # database of the CLI phases (written compressed to disk)
C_STAGED = 8       # clips / streams of the staged wavvq batch and pool
C_RAW = 4          # clips / streams of the shipped raw-wav batch and pool
POSE_ATOL = 1e-3   # card vs CPU poses: float32 decode, other sum orders
# K2 against its plain version: float32 differs by summation order; in
# bfloat16 the kernel rounds p against a running (per key tile) max and the
# plain version against the row max, one bfloat16 rounding (2^-8) apart.
K2_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
# WavLM-Large features (unit scale after the last LayerNorm): float32 on
# both sides, other summation orders through 24 layers.
FEAT_ATOL = 2e-3
# WavLM-Large at precision="default", card against CPU: the same bfloat16
# operands, but another summation order (and the tensor cores' float32
# accumulation) can move an activation across a bfloat16 rounding edge
# (2^-8 relative), and 24 layers carry such flips on: 0.1 on features of
# scale ~4.5, five times the bfloat16 step there.
DEFAULT_FEAT_ATOL = 0.1
# MiniLM context embeddings (LayerNorm scale, mean-pooled), card against
# CPU: float32 on both sides (TF32 off), other summation orders, 6 layers.
MINILM_ATOL = 2e-5
# phase 15: four BEAT-like recordings; split_of gives train, train, test,
# validation
REC_SECONDS = 60.0
REC_NAMES = ("1_smoke_0_1_1", "1_smoke_0_2_2", "1_smoke_0_103_103",
             "1_smoke_0_111_111")
# PAE phases, card against CPU: float32 on both sides (TF32 off), other
# summation orders through the 240-tap convs and the FFT; p on the circle
PHASE_ATOL = 1e-4
PHASE_CHECK_ROWS = 48  # CPU rows checked at 3 places of each recording
# the decoded codebook signature (poses of unit scale), card against CPU
SIGNATURE_ATOL = 1e-3
# a VQ code may differ from the CPU's only between candidates whose squared
# distances differ by float32 rounding, relative to the terms summed
CODE_GAP_RTOL = 1e-6
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # float32 outside the tensor cores (TF32 off)
BF16_TC_FLOPS = 989e12      # bfloat16 tensor cores, dense
# 32-bit ALU operations an SM issues per clock: 4 schedulers x 32 lanes,
# the rate behind the data sheet's 67 TFLOP/s float32 (an FMA counted as
# two). K1 runs above the 64/clock of the integer-only units on the
# whole-corpus shape, so this is the peak its operations are held to.
ALU_OPS_PER_SM_CLOCK = 128
# device_ms's spin ahead of the timed calls: ~50 ms at the H100's 1980 MHz
SLEEP_CYCLES = 100_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"
                          if query == "clocks.max.sm" else
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, n: int, warmup: int = 3) -> float:
    """Median of n CUDA-event timings of fn() after warm-up calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n: int, reps: int = 5, warmup: int = 3) -> float:
    """Device time per call of fn: median over reps of the CUDA-event time
    of n calls, divided by n. The calls are queued behind a spinning kernel
    (torch.cuda._sleep), so the card runs them back to back however slowly
    the host enqueues them; median_ms of one call also counts the host's
    time between its events. If the card finishes spinning before the last
    call is queued, the spin doubles and the repetition runs again."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles, times = SLEEP_CYCLES, []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        caught_up = start.query()
        end.synchronize()
        if caught_up:
            if cycles >= 16 * SLEEP_CYCLES:
                raise SystemExit("device_ms: the card caught up with the "
                                 "host behind an 800 ms spin: the timed "
                                 "call synchronises")
            cycles *= 2
            continue
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def log_profile(phase: str, fn) -> dict:
    """Profile one call of fn: device busy time, idle share, top kernels.
    Returns {kernel name: (total device us, count)}."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"{phase} profile: device busy {busy_us / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms wall (idle share "
        f"{1 - busy_us / wall_us:.3f}); top kernels:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:9.4f} ms x{e.count:5d} "
            f"{e.key[:90]}")
    return {e.key: (e.self_device_time_total, e.count) for e in kernels}


def skeleton_bvh_text(rng, n_frames: int = 48, fps: int = 120,
                      smooth: bool = False) -> str:
    """A BEAT-like skeleton holding the 15 upper-body target joints under a
    Hips root, with random motion: independent per frame, or (smooth) three
    sinusoids of 0.2-2.5 Hz per channel, as recorded gestures move."""
    import numpy as np
    children = {
        "Hips": ["Spine"], "Spine": ["Spine1"], "Spine1": ["Spine2"],
        "Spine2": ["Spine3"],
        "Spine3": ["Neck", "RightShoulder", "LeftShoulder"],
        "Neck": ["Neck1"], "Neck1": ["Head"], "Head": [],
        "RightShoulder": ["RightArm"], "RightArm": ["RightForeArm"],
        "RightForeArm": ["RightHand"], "RightHand": [],
        "LeftShoulder": ["LeftArm"], "LeftArm": ["LeftForeArm"],
        "LeftForeArm": ["LeftHand"], "LeftHand": [],
    }
    lines = ["HIERARCHY"]
    n_ch = 0

    def emit(joint, depth):
        nonlocal n_ch
        tab = "\t" * depth
        lines.append(f"{tab}{'ROOT' if depth == 0 else 'JOINT'} {joint}")
        lines.append(tab + "{")
        lines.append(f"{tab}\tOFFSET {rng.uniform(-4, 4):.3f} "
                     f"{rng.uniform(1, 8):.3f} 0.000")
        if depth == 0:
            lines.append(f"{tab}\tCHANNELS 6 Xposition Yposition Zposition "
                         "Zrotation Xrotation Yrotation")
            n_ch += 6
        else:
            lines.append(f"{tab}\tCHANNELS 3 Zrotation Xrotation Yrotation")
            n_ch += 3
        for c in children[joint]:
            emit(c, depth + 1)
        if not children[joint]:
            lines.extend([f"{tab}\tEnd Site", f"{tab}\t{{",
                          f"{tab}\t\tOFFSET 0.000 3.000 0.000", f"{tab}\t}}"])
        lines.append(tab + "}")

    emit("Hips", 0)
    lines += ["MOTION", f"Frames: {n_frames}", f"Frame Time: {1.0 / fps:.6f}"]
    if smooth:
        t = np.arange(n_frames)[:, None] / fps
        motion = sum(rng.uniform(2, 20, n_ch) * np.sin(
            2 * np.pi * rng.uniform(0.2, 2.5, n_ch) * t
            + rng.uniform(0, 2 * np.pi, n_ch)) for _ in range(3))
    else:
        motion = rng.uniform(-30, 30, size=(n_frames, n_ch))
    for row in motion:
        lines.append(" ".join(f"{v:.4f}" for v in row))
    return "\n".join(lines) + "\n"


def make_data(rng):
    """Seeded synthetic speaker database and test clips at the shapes of
    tests/fixtures.py (only the arrays the wavvq preset reads)."""
    import numpy as np
    from qpgesture_tpu_torch.core import constants as C
    from qpgesture_tpu_torch.core.schemas import (CodebookSignature,
                                                  DatabaseBundle)
    bundle = DatabaseBundle(
        context=rng.randn(J, C.NUM_FRAMES_CODE, 1,
                          C.CONTEXT_DIM).astype(np.float32),
        phase=np.stack([
            rng.rand(J, C.NUM_FRAMES, 8),      # phase in [0, 1)
            rng.rand(J, C.NUM_FRAMES, 8) * 4,  # freq
            rng.rand(J, C.NUM_FRAMES, 8),      # amplitude
            rng.randn(J, C.NUM_FRAMES, 8) * .1,  # offset
        ], axis=2).astype(np.float32))
    K = C.CODEBOOK_SIZE
    codes = rng.randint(0, K, size=(J, C.NUM_FRAMES_CODE)).astype(np.int32)
    signature = CodebookSignature(
        code=np.tile(np.arange(K)[:, None], (1, C.NUM_FRAMES_CODE)),
        poses=rng.randn(K, C.NUM_FRAMES, C.POSE_DIM).astype(np.float32),
        signature=rng.randn(K, C.POSE_DIM).astype(np.float32))
    wavvq = rng.randint(0, C.WAVVQ_VOCAB,
                        size=(J, C.WAVVQ_FRAMES, 2)).astype(np.int32)
    clips = [(rng.randint(0, C.WAVVQ_VOCAB, size=(W, C.WAVVQ_FRAMES, 2)
                          ).astype(np.int32),
              rng.randn(W, C.NUM_FRAMES_CODE, 1,
                        C.CONTEXT_DIM).astype(np.float32))
             for _ in range(N_REQUESTS + 1)]
    return bundle, codes, signature, wavvq, clips


def lev_bound(Q: int, N: int, L: int, sm_count: int, sm_clock_hz: float):
    """(bound_ms, bound_by) for a (Q, L) x (N, L) edit-distance matrix: the
    larger of its bytes (inputs once, output once) over HBM bandwidth and
    its int32 operations over the card's 32-bit ALU issue rate
    (ALU_OPS_PER_SM_CLOCK per SM per clock). A DP cell takes at least 4
    operations: the symbol compare, min(up, left), diag + cost, and one
    fused add-min (Hopper's DPX VIADDMNMX); L*L cells per pair."""
    bytes_ms = 1e3 * 4 * (Q * L + N * L + Q * N) / HBM_BYTES_PER_S
    ops_ms = 1e3 * 4 * Q * N * L * L / (sm_count * ALU_OPS_PER_SM_CLOCK
                                        * sm_clock_hz)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def flash_bound(B: int, H: int, T: int, hd: int, in_bytes: int,
                gated: bool, flops_per_s: float):
    """(bound_ms, bound_by) for gated attention: the larger of its
    4*B*H*T^2*hd operations (two products) over the card's rate for the
    input type, and its bytes (q, k, v and the gate read once in the input
    type, the bias read once, the float32 output written once) over HBM
    bandwidth."""
    ops_ms = 1e3 * 4 * B * H * T * T * hd / flops_per_s
    n_bytes = (in_bytes * (3 * B * H * T * hd + H * T * T
                           + (B * H * T if gated else 0))
               + 4 * B * H * T * hd)
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def phase_k2(dev):
    """K2 against its plain version at the kernels' tile edges and the
    WavLM shapes, in both instantiations; then the times of K2, its plain
    version and SDPA at the main-path shape in float32 and in bfloat16.
    Returns the kernels-line fields measured here (float32, the main
    path's)."""
    import torch
    import torch.nn.functional as F
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2

    gen = torch.Generator().manual_seed(SEED)

    def inputs(B, H, T, hd, gated):
        q, k, v = (torch.randn(B, H, T, hd, generator=gen).to(dev)
                   for _ in range(3))
        bias = torch.randn(H, T, T, generator=gen).to(dev)
        gate = (1.0 + torch.rand(B, H, T, generator=gen)).to(dev) \
            if gated else None
        return q, k, v, bias, gate

    f32, bf16 = torch.float32, torch.bfloat16
    # (B, H, T, hd): the 32-key and 16-/64-query tile edges, WavLM's
    # windows (T=199) and a whole 24 s clip (T=1200); hd 16 and 32 once
    shapes = [(2, 16, T, 64) for T in (1, 31, 32, 33, 63, 64, 65)] + \
        [(6, 16, 199, 64), (24, 16, 199, 64), (1, 16, 1200, 64),
         (2, 16, 65, 16), (2, 16, 65, 32)]
    max_err = 0.0
    for B, H, T, hd in shapes:
        for gated in (True, False):
            x = inputs(B, H, T, hd, gated)
            for dtype in (f32, bf16):
                got = K2.gated_flash_attention(*x, sm_scale=hd ** -0.5,
                                               kernel_dtype=dtype)
                torch.cuda.synchronize()
                want = K2.gated_attention_plain(*x, sm_scale=hd ** -0.5,
                                                kernel_dtype=dtype)
                err = float((got - want).abs().max())
                tol = K2_ATOL[str(dtype).split(".")[-1]]
                log(f"phase 6 K2 B={B} H={H} T={T} hd={hd} "
                    f"{'gated' if gated else 'no gate'} {dtype}: "
                    f"max_abs_err={err:.3e} (tol {tol})")
                if not err <= tol:
                    raise SystemExit(f"K2 disagrees with its plain version "
                                     f"at T={T} hd={hd} {dtype}")
                if dtype == f32:
                    max_err = max(max_err, err)

    # Times at the main-path shape, on the inputs the main path hands the
    # kernel: q, k, v, gate in the kernel dtype, the bias already in the
    # kernel's layout (WavLM prepares it once per forward). The library
    # yardstick is one SDPA call on the same inputs in the same dtype, q
    # pre-scaled and the gated bias materialised as its mask outside the
    # timed call (measured only; the port never calls it).
    scale = 64 ** -0.5
    q, k, v, bias, gate = inputs(6, 16, 199, 64, True)
    line = {}
    for dtype, rate, in_bytes in ((f32, F32_FLOPS, 4),
                                  (bf16, BF16_TC_FLOPS, 2)):
        xq, xk, xv, xg = (t.to(dtype) for t in (q, k, v, gate))
        xb = K2.prepare_bias(bias, dtype)
        qs = (q * scale).to(dtype)
        mask = (gate[..., None] * bias[None]).to(dtype)
        sdpa_err = float((F.scaled_dot_product_attention(
            qs, xk, xv, attn_mask=mask, scale=1.0).float()
            - K2.gated_attention_plain(q, k, v, bias, gate, sm_scale=scale,
                                       kernel_dtype=dtype)).abs().max())
        calls = {
            "kernel": lambda: K2.gated_flash_attention(
                xq, xk, xv, xb, xg, sm_scale=scale, kernel_dtype=dtype),
            "plain": lambda: K2.gated_attention_plain(
                xq, xk, xv, xb, xg, sm_scale=scale, kernel_dtype=dtype),
            "library": lambda: F.scaled_dot_product_attention(
                qs, xk, xv, attn_mask=mask, scale=1.0),
        }
        ms = {name: device_ms(fn, 20) for name, fn in calls.items()}
        call_ms = median_ms(calls["kernel"], 20)
        bound_ms, bound_by = flash_bound(6, 16, 199, 64, in_bytes, True,
                                         rate)
        log(f"phase 6 K2 times at B=6 H=16 T=199 hd=64 {dtype}: "
            f"kernel_ms={ms['kernel']:.5f} plain_ms={ms['plain']:.5f} "
            f"library_ms={ms['library']:.5f} (SDPA, max_abs_err vs plain "
            f"{sdpa_err:.3e}) bound_ms={bound_ms:.5f} ({bound_by}); one "
            f"kernel call between two events {call_ms:.5f}, host cost per "
            f"call {call_ms - ms['kernel']:+.5f} ms")
        if dtype == f32:
            line = dict(max_abs_err=max_err, ms=ms["kernel"],
                        plain_ms=ms["plain"], bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=ms["library"])
    q, k, v, bias, gate = inputs(1, 16, 1200, 64, True)
    for dtype, rate, in_bytes in ((f32, F32_FLOPS, 4),
                                  (bf16, BF16_TC_FLOPS, 2)):
        x = [t.to(dtype) for t in (q, k, v)] + [
            K2.prepare_bias(bias, dtype), gate.to(dtype)]
        t_ms = device_ms(lambda: K2.gated_flash_attention(
            *x, sm_scale=scale, kernel_dtype=dtype), 20)
        b_ms, b_by = flash_bound(1, 16, 1200, 64, in_bytes, True, rate)
        log(f"phase 6 K2 times at B=1 H=16 T=1200 hd=64 {dtype}: "
            f"kernel_ms={t_ms:.5f} bound_ms={b_ms:.5f} ({b_by})")
    # serve_batch's shape: C_RAW clips of W windows in one encoder batch
    B = C_RAW * W
    q, k, v, bias, gate = inputs(B, 16, 199, 64, True)
    for dtype, rate, in_bytes in ((f32, F32_FLOPS, 4),
                                  (bf16, BF16_TC_FLOPS, 2)):
        xq, xk, xv, xg = (t.to(dtype) for t in (q, k, v, gate))
        xb = K2.prepare_bias(bias, dtype)
        qs = (q * scale).to(dtype)
        mask = (gate[..., None] * bias[None]).to(dtype)
        t_ms = device_ms(lambda: K2.gated_flash_attention(
            xq, xk, xv, xb, xg, sm_scale=scale, kernel_dtype=dtype), 20)
        sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qs, xk, xv, attn_mask=mask, scale=1.0), 20)
        b_ms, b_by = flash_bound(B, 16, 199, 64, in_bytes, True, rate)
        log(f"phase 6 K2 times at B={B} H=16 T=199 hd=64 {dtype}: "
            f"kernel_ms={t_ms:.5f} library_ms={sdpa_ms:.5f} (SDPA) "
            f"bound_ms={b_ms:.5f} ({b_by})")
    return line


def k2_times(dev, B: int) -> dict:
    """Float32 K2 and SDPA device times at (B, 16, 199, 64), gated, on the
    inputs WavLM hands the kernel, with the bound of that work."""
    import torch
    import torch.nn.functional as F
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2

    gen = torch.Generator().manual_seed(SEED + B)
    q, k, v = (torch.randn(B, 16, 199, 64, generator=gen).to(dev)
               for _ in range(3))
    bias = torch.randn(16, 199, 199, generator=gen).to(dev)
    gate = (1.0 + torch.rand(B, 16, 199, generator=gen)).to(dev)
    scale = 64 ** -0.5
    xb = K2.prepare_bias(bias, torch.float32)
    qs, mask = q * scale, gate[..., None] * bias[None]
    bound_ms, bound_by = flash_bound(B, 16, 199, 64, 4, True, F32_FLOPS)
    return dict(
        ms=device_ms(lambda: K2.gated_flash_attention(
            q, k, v, xb, gate, sm_scale=scale,
            kernel_dtype=torch.float32), 20),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, scale=1.0), 20),
        bound_ms=bound_ms, bound_by=bound_by)


def phase_rawwav_shipped(dev, rng, bundle, codes, signature, vqvae_gpu,
                         vqvae_cpu, data_mean, data_std):
    """Raw-wav serving of the shipped preset at full WavLM-Large width.
    Returns (K2 launches of the main run, what the "default" phase reuses:
    the encoders, the engine, the requests and their codes)."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.core.config import MATCH_PRESETS
    from qpgesture_tpu_torch.match import engine as eng
    from qpgesture_tpu_torch.match.database import (stage_database,
                                                    stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.models.wavlm import WavLM, WavLMConfig
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.serve import RawWavServer, ServingPipeline

    t0 = time.time()
    wcfg = WavLMConfig()
    torch.manual_seed(SEED)
    enc_cpu = WavLM(wcfg, device="cpu")
    with torch.no_grad():   # a gate that is not ~constant
        for name, p in enc_cpu.named_parameters():
            if "grep_linear" in name:
                p.mul_(8.0)
    enc_gpu = copy.deepcopy(enc_cpu).to(dev)
    n_params = sum(p.numel() for p in enc_cpu.parameters())
    feats_db = np.random.default_rng(SEED).standard_normal(
        (J, 199, wcfg.encoder_embed_dim), dtype=np.float32)
    cfg = MATCH_PRESETS["shipped"]
    db = stage_database(cfg, bundle, codes, signature, wavlm=feats_db)
    engine = eng.CodeKNNEngine(cfg, db, device=dev)
    server = RawWavServer(engine, vqvae_gpu, enc_gpu, data_mean, data_std)
    wavs = [(rng.randn(W, 64000) * 3000).astype(np.int16)
            for _ in range(N_REQUESTS + 1)]
    ctxs = [rng.randn(W, 30, 1, 384).astype(np.float32)
            for _ in range(N_REQUESTS + 1)]
    torch.cuda.synchronize()
    log(f"phase 7 set-up: WavLM-Large {n_params} parameters, {wcfg.encoder_layers}"
        f" layers, D={wcfg.encoder_embed_dim}; wavlm database "
        f"{feats_db.nbytes / 1e6:.0f} MB on the host, "
        f"{db.aud_feat.nbytes / 1e6:.0f} MB staged; {time.time() - t0:.1f} s")

    def serve(r):
        return server.serve(wavs[r], ctxs[r], init_code=0,
                            rng=np.random.RandomState(cfg.seed))

    serve(N_REQUESTS)                   # warm-up request
    torch.cuda.synchronize()
    K1.launches = K2.launches = 0
    served, req_ms = [], []
    for r in range(N_REQUESTS):
        before = K2.launches
        t0 = time.perf_counter()
        served.append(serve(r))          # returns host arrays: synced
        req_ms.append(1e3 * (time.perf_counter() - t0))
        if K2.launches - before != wcfg.encoder_layers:
            raise SystemExit(f"request {r} launched K2 "
                             f"{K2.launches - before} times, not "
                             f"{wcfg.encoder_layers}")
    k2_launches = K2.launches
    log(f"phase 7 serve p50 {statistics.median(req_ms):.3f} ms over "
        f"{N_REQUESTS} requests (W={W}, J={J}); K2 launches {k2_launches} "
        f"({wcfg.encoder_layers} per request), K1 launches {K1.launches}")

    pipe = ServingPipeline(engine, vqvae_gpu, data_mean, data_std)
    for r, (codes_r, poses_r) in enumerate(served):
        feats = server.encode(wavs[r])
        again = server.encode(wavs[r])
        ta = stage_test_audio(cfg, db, wavlm=feats.cpu().numpy())
        tc = stage_test_context(db, ctxs[r])
        want, _ = pipe.serve(ta, tc, init_code=0,
                             rng=np.random.RandomState(cfg.seed))
        if codes_r.shape != (W, 30) or poses_r.shape != (W * 240, 135) \
                or not np.isfinite(poses_r).all():
            raise SystemExit(f"request {r}: shapes {codes_r.shape} "
                             f"{poses_r.shape} or non-finite poses")
        if not np.array_equal(codes_r, want):
            raise SystemExit(f"request {r}: raw-wav codes differ from "
                             f"host-staged serving of the card's features")
        log(f"phase 7 request {r}: {req_ms[r]:.3f} ms, codes == host-staged "
            f"serving on the card's features; features {tuple(feats.shape)}"
            f", bit-equal across two encodes: {torch.equal(feats, again)}")

    # the same card weights with the eager attention
    eager = WavLM(dataclasses.replace(wcfg, attn_impl="eager"), device=dev)
    eager.load_state_dict(enc_gpu.state_dict())
    x = torch.as_tensor(wavs[0], device=dev).float() / 32768.0
    feats_flash = enc_gpu(x)
    before = K2.launches
    feats_eager = eager(x)
    if K2.launches != before:
        raise SystemExit("the eager encoder launched K2")
    err = float((feats_flash - feats_eager).abs().max())
    log(f"phase 7 card features K2 vs eager attention: max_abs_err "
        f"{err:.3e} (tol {FEAT_ATOL}), feature scale "
        f"{float(feats_eager.abs().max()):.3f}")
    if not err <= FEAT_ATOL:
        raise SystemExit("K2 features differ from the eager attention's")
    del eager

    # one request against the CPU port (its encoder, staging and engine)
    t0 = time.time()
    ref_engine = eng.CodeKNNEngine(cfg, db, device="cpu")
    ref = RawWavServer(ref_engine, vqvae_cpu, enc_cpu, data_mean, data_std)
    feats_cpu = ref.encode(wavs[0])
    err = float((feats_flash.cpu() - feats_cpu).abs().max())
    # RawWavServer.serve's own steps, with the features kept for the check
    codes_cpu, _ = ServingPipeline(ref_engine, vqvae_cpu).serve(
        *ref.stage(feats_cpu, ctxs[0]), init_code=0,
        rng=np.random.RandomState(cfg.seed))
    same = codes_cpu == served[0][0]
    log(f"phase 7 card vs CPU port, request 0: features max_abs_err "
        f"{err:.3e} (tol {FEAT_ATOL}); equal codes {int(same.sum())}/"
        f"{same.size} (share {same.mean():.4f}); differing (window, slot): "
        f"{[tuple(map(int, i)) for i in np.argwhere(~same)]}; "
        f"{time.time() - t0:.1f} s")
    if not err <= FEAT_ATOL:
        raise SystemExit("card features differ from the CPU port's")

    # where the time goes in one request (not counted as launches)
    enc0 = server.encode(wavs[0])
    ta0, tc0 = server.stage(enc0, ctxs[0])
    zeros = np.zeros((8, 16), np.float32)
    codes0 = torch.as_tensor(served[0][0].reshape(1, -1), device=dev)
    encoder_ms = median_ms(lambda: server.encode(wavs[0]), 5, warmup=1)
    stage_ms = median_ms(lambda: server.stage(enc0, ctxs[0]), 10)
    match_ms = median_ms(lambda: engine.predict_device(
        ta0, tc0, init_code=0, init_phase=zeros), 5, warmup=1)
    decode_ms = median_ms(lambda: vqvae_gpu.decode(codes0), 10)
    log(f"phase 7 stage times: encoder_ms={encoder_ms:.4f} "
        f"stage_ms={stage_ms:.4f} match_ms={match_ms:.4f} "
        f"decode_ms={decode_ms:.4f}")
    kernels = log_profile("phase 7", lambda: serve(0))
    k2 = [(us, n) for key, (us, n) in kernels.items()
          if "gated_flash_kernel" in key]
    if not k2:
        raise SystemExit("the profiled raw-wav request shows no K2 kernel")
    log(f"phase 7 K2 in the profiled request: {k2[0][1]} launches, "
        f"{k2[0][0] / k2[0][1] / 1e3:.5f} ms per launch")
    return k2_launches, dict(
        enc_cpu=enc_cpu, enc_gpu=enc_gpu, feats_db=feats_db, cfg=cfg, db=db,
        engine=engine, wavs=wavs, ctxs=ctxs,
        codes=[c for c, _ in served], feats=feats_flash)


def phase_rawwav_default(dev, ctx, vqvae_gpu, data_mean, data_std):
    """Raw-wav serving of the shipped preset with the encoder at
    precision="default" (bfloat16 contractions, K2 in bfloat16), on the
    weights and requests of phase 7."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.match.database import (stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.models.wavlm import WavLM
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.serve import RawWavServer, ServingPipeline

    t0 = time.time()
    cfg, db, wavs, ctxs = ctx["cfg"], ctx["db"], ctx["wavs"], ctx["ctxs"]
    wcfg = dataclasses.replace(ctx["enc_cpu"].cfg, precision="default")
    enc_gpu = WavLM(wcfg, device=dev)
    enc_gpu.load_state_dict(ctx["enc_gpu"].state_dict())
    server = RawWavServer(ctx["engine"], vqvae_gpu, enc_gpu, data_mean,
                          data_std)

    def serve(r):
        return server.serve(wavs[r], ctxs[r], init_code=0,
                            rng=np.random.RandomState(cfg.seed))

    serve(N_REQUESTS)                   # warm-up request
    torch.cuda.synchronize()
    log(f"phase 8 set-up: WavLM-Large at precision=\"default\", phase 7's"
        f" weights; {time.time() - t0:.1f} s")
    K2.launches = 0
    served, req_ms = [], []
    for r in range(N_REQUESTS):
        before = K2.launches
        t0 = time.perf_counter()
        served.append(serve(r))
        req_ms.append(1e3 * (time.perf_counter() - t0))
        if K2.launches - before != wcfg.encoder_layers:
            raise SystemExit(f"default request {r} launched K2 "
                             f"{K2.launches - before} times, not "
                             f"{wcfg.encoder_layers}")
    k2_launches = K2.launches

    pipe = ServingPipeline(ctx["engine"], vqvae_gpu, data_mean, data_std)
    n_same = n_clips_same = 0
    for r, (codes_r, poses_r) in enumerate(served):
        feats = server.encode(wavs[r])
        want, _ = pipe.serve(stage_test_audio(cfg, db,
                                              wavlm=feats.cpu().numpy()),
                             stage_test_context(db, ctxs[r]), init_code=0,
                             rng=np.random.RandomState(cfg.seed))
        if codes_r.shape != (W, 30) or not np.isfinite(poses_r).all():
            raise SystemExit(f"default request {r}: shape {codes_r.shape} "
                             f"or non-finite poses")
        if not np.array_equal(codes_r, want):
            raise SystemExit(f"default request {r}: raw-wav codes differ "
                             f"from host-staged serving of the card's "
                             f"features")
        same = codes_r == ctx["codes"][r]
        n_same += int(same.sum())
        n_clips_same += int(same.all())
    agreement = n_same / (N_REQUESTS * W * 30)
    log(f"phase 8 serve p50 {statistics.median(req_ms):.3f} ms over "
        f"{N_REQUESTS} requests; K2 launches {k2_launches} "
        f"({wcfg.encoder_layers} per request); codes == host-staged serving "
        f"of the card's \"default\" features in every request; against "
        f"phase 7's \"highest\" codes: index_agreement {agreement:.4f} "
        f"({n_same}/{N_REQUESTS * W * 30}), clips_identical "
        f"{n_clips_same}/{N_REQUESTS}")

    # the card's "default" features against the CPU port's "default", on
    # two windows of request 0
    t0 = time.time()
    enc_cpu = WavLM(wcfg, device="cpu")
    enc_cpu.load_state_dict(ctx["enc_cpu"].state_dict())
    x = torch.as_tensor(wavs[0][:2]).float() / 32768.0
    feats_cpu = enc_cpu(x)
    feats_gpu = enc_gpu(x.to(dev))
    err = float((feats_gpu.cpu() - feats_cpu).abs().max())
    vs_highest = float((feats_gpu - ctx["feats"][:2]).abs().max())
    log(f"phase 8 card vs CPU port at \"default\", request 0 windows 0-1: "
        f"features max_abs_err {err:.3e} (tol {DEFAULT_FEAT_ATOL}); card "
        f"\"default\" vs \"highest\" features: max_abs_diff "
        f"{vs_highest:.3e}; {time.time() - t0:.1f} s")
    if not err <= DEFAULT_FEAT_ATOL:
        raise SystemExit("card \"default\" features differ from the CPU "
                         "port's")
    del enc_cpu

    encoder_ms = median_ms(lambda: server.encode(wavs[0]), 5, warmup=1)
    log(f"phase 8 stage times: encoder_ms={encoder_ms:.4f}")
    kernels = log_profile("phase 8", lambda: serve(0))
    k2 = [(us, n) for key, (us, n) in kernels.items()
          if "gated_flash_kernel_bf16" in key]
    if not k2 or k2[0][1] != wcfg.encoder_layers:
        raise SystemExit("the profiled \"default\" request shows no "
                         "bfloat16 K2 kernel")
    log(f"phase 8 bfloat16 K2 in the profiled request: {k2[0][1]} "
        f"launches, {k2[0][0] / k2[0][1] / 1e3:.5f} ms per launch")
    return k2_launches


def phase_rawwav_wavvq(dev, rng, serving, db, cfg):
    """Raw-wav serving of the wavvq preset with a random vq-wav2vec."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.match.database import (stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.models.vq_wav2vec import VQWav2Vec
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.serve import RawWavServer

    torch.manual_seed(SEED + 1)
    encoder = VQWav2Vec(device=dev)
    server = RawWavServer(serving.engine, serving.model, encoder,
                          serving.data_mean, serving.data_std)
    wavs = [(rng.randn(W, 64000) * 3000).astype(np.int16)
            for _ in range(N_REQUESTS + 1)]
    ctxs = [rng.randn(W, 30, 1, 384).astype(np.float32)
            for _ in range(N_REQUESTS + 1)]

    def serve(r):
        return server.serve(wavs[r], ctxs[r], init_code=0,
                            rng=np.random.RandomState(cfg.seed))

    serve(N_REQUESTS)                   # warm-up request
    torch.cuda.synchronize()
    K1.launches = K2.launches = 0
    served, req_ms = [], []
    for r in range(N_REQUESTS):
        before = K1.launches
        t0 = time.perf_counter()
        served.append(serve(r))
        req_ms.append(1e3 * (time.perf_counter() - t0))
        if K1.launches <= before:
            raise SystemExit(f"wavvq raw-wav request {r} did not launch K1")
    k1_launches = K1.launches
    for r, (codes_r, _) in enumerate(served):
        enc = server.encode(wavs[r]).cpu().numpy()
        want, _ = serving.serve(stage_test_audio(cfg, db, wavvq=enc),
                                stage_test_context(db, ctxs[r]),
                                init_code=0,
                                rng=np.random.RandomState(cfg.seed))
        if enc.shape != (W, 398, 2) or not np.array_equal(codes_r, want):
            raise SystemExit(f"wavvq raw-wav request {r}: codes differ from "
                             f"host-staged serving of the card's codes")
    encoder_ms = median_ms(lambda: server.encode(wavs[0]), 10)
    log(f"phase 9 wavvq raw-wav serve p50 {statistics.median(req_ms):.3f} "
        f"ms over {N_REQUESTS} requests; encoder_ms={encoder_ms:.4f}; codes"
        f" == host-staged serving of the card's vq-wav2vec codes; K1 "
        f"launches {k1_launches}, K2 launches {K2.launches}")
    return k1_launches


def phase_generate(rng, bundle, codes, signature, feats_db, enc_cpu,
                   vqvae_cpu):
    """generate --preset shipped, wav file -> BVH, on the default device
    (cuda). The WavLM checkpoint keeps 2 of WavLM-Large's 24 layers; the
    database keeps J_CLI of the J sequences."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.schemas import save_codes, save_wavlm
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    from qpgesture_tpu_torch.motion.pipeline import MotionPipeline
    from qpgesture_tpu_torch.pipelines.audio_prep import write_wav

    layers = 2
    cfg = dataclasses.replace(enc_cpu.cfg, encoder_layers=layers)
    sd = {k: v for k, v in enc_cpu.state_dict().items()
          if not k.startswith("encoder.layers.")
          or int(k.split(".")[2]) < layers}
    with tempfile.TemporaryDirectory() as tmp:
        p = lambda name: os.path.join(tmp, name)
        t0 = time.time()
        write_wav(p("speech.wav"), rng.randn(24 * 16000) * 0.1, 16000)
        torch.save({"cfg": {k: v for k, v in dataclasses.asdict(cfg).items()
                            if k != "conv_feature_layers"},
                    "model": sd}, p("wavlm.pt"))
        dataclasses.replace(bundle, context=bundle.context[:J_CLI],
                            phase=bundle.phase[:J_CLI]).save(p("db.npz"))
        save_codes(p("codes.npz"), codes[:J_CLI])
        signature.save(p("code.npz"))
        save_wavlm(p("wavlm.npz"), feats_db[:J_CLI])
        torch.save({"model_dict": vqvae_cpu.state_dict()}, p("vqvae.bin"))
        pipe = MotionPipeline(fps=60).fit(parse_bvh(skeleton_bvh_text(rng)))
        with open(p("pipeline.json"), "w") as f:
            f.write(pipe.to_json())
        t1 = time.time()
        cli(["generate", "--wav", p("speech.wav"),
             "--train-database", p("db.npz"),
             "--train-codebook", p("codes.npz"),
             "--codebook-signature", p("code.npz"),
             "--train-wavlm", p("wavlm.npz"),
             "--wavlm-checkpoint", p("wavlm.pt"),
             "--vqvae-checkpoint", p("vqvae.bin"),
             "--pipeline", p("pipeline.json"), "--preset", "shipped",
             "--out", p("out"), "--prefix", "smoke"])
        bvh = parse_bvh(p(os.path.join("out", "smoke_generated.bvh")))
        if bvh.values.shape != (W * 240, len(bvh.channel_names)) or \
                not np.isfinite(bvh.values).all():
            raise SystemExit(f"generate BVH {bvh.values.shape}")
        log(f"phase 10 generate --preset shipped: 24 s wav -> BVH "
            f"{bvh.values.shape} parsed back; {layers}-layer WavLM "
            f"checkpoint, J={J_CLI} database; files {t1 - t0:.1f} s, "
            f"command {time.time() - t1:.1f} s")


def phase_batch(dev, rng, serving, db, cfg, shipped, vqvae_gpu, data_mean,
                data_std):
    """Batched serving: predict_batch of C_STAGED staged wavvq clips against
    solo predict (exact: integer edit distances), and RawWavServer.
    serve_batch of the shipped preset at full WavLM-Large width against
    predict_batch over host staging of the card's own batched features.
    Returns (K1 launches, K2 launches, the staged clips and their seeds and
    codes for phase 12)."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.core import constants as const
    from qpgesture_tpu_torch.match.database import (stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.serve import RawWavServer

    # -- wavvq, staged: C_STAGED clips of W windows, explicit seeds --------
    engine = serving.engine
    C = C_STAGED
    ta = np.stack([stage_test_audio(cfg, db, wavvq=rng.randint(
        0, const.WAVVQ_VOCAB, size=(W, const.WAVVQ_FRAMES, 2)
    ).astype(np.int32)) for _ in range(C)])
    tc = np.stack([stage_test_context(db, rng.randn(
        W, 30, 1, 384).astype(np.float32)) for _ in range(C)])
    inits = rng.randint(0, 512, C).astype(np.int32)
    phases0 = rng.rand(C, 8, 16).astype(np.float32)

    def batch():
        return engine.predict_batch(ta, tc, init_codes=inits,
                                    init_phases=phases0)

    def sequential():
        return [engine.predict(ta[c], tc[c], init_code=int(inits[c]),
                               init_phase=phases0[c]) for c in range(C)]

    batch()                              # warm-up
    torch.cuda.synchronize()
    K1.launches = K2.launches = 0
    got = batch()
    k1_launches = K1.launches
    if k1_launches != 1:
        raise SystemExit(f"predict_batch launched K1 {k1_launches} times")
    for c, (g, s) in enumerate(zip(got, sequential())):
        if not (np.array_equal(g.codes, s.codes)
                and np.array_equal(g.phases, s.phases)
                and np.array_equal(g.votes, s.votes)):
            raise SystemExit(f"predict_batch lane {c} differs from solo "
                             f"predict")
    batch_ms = median_ms(batch, 5, warmup=1)
    seq_ms = median_ms(sequential, 3, warmup=0)
    log(f"phase 11 wavvq predict_batch C={C} W={W} (Q={C * W * 8}): every "
        f"lane == solo predict (codes, phases, votes); K1 launches "
        f"{k1_launches}; batch_ms={batch_ms:.3f} ({1e3 * C / batch_ms:.1f}"
        f" clips/s) vs {C} sequential predict {seq_ms:.3f} ms "
        f"({1e3 * C / seq_ms:.1f} clips/s), x{seq_ms / batch_ms:.2f}")
    log_profile("phase 11 wavvq predict_batch", batch)

    # -- shipped, raw wav: phase 7's requests as one batch ----------------
    s_cfg, s_db, s_engine = shipped["cfg"], shipped["db"], shipped["engine"]
    server = RawWavServer(s_engine, vqvae_gpu, shipped["enc_gpu"], data_mean,
                          data_std)
    CB = C_RAW
    wav = np.stack(shipped["wavs"][:CB])              # (CB, W, 64000) int16
    ctx = np.stack(shipped["ctxs"][:CB])
    zeros_c = np.zeros(CB, np.int32)
    zeros_p = np.zeros((CB, 8, 16), np.float32)

    def serve_batch():
        return server.serve_batch(wav, ctx, zeros_c, zeros_p,
                                  rng=np.random.RandomState(s_cfg.seed))

    def serve_solo(c):
        return server.serve(wav[c], ctx[c], init_code=0,
                            rng=np.random.RandomState(s_cfg.seed))

    serve_batch()                        # warm-up
    torch.cuda.synchronize()
    K1.launches = K2.launches = 0
    codes_b, poses_b = serve_batch()
    k2_launches = K2.launches
    if k2_launches != shipped["enc_gpu"].cfg.encoder_layers:
        raise SystemExit(f"serve_batch launched K2 {k2_launches} times")
    if codes_b.shape != (CB, W, 30) or poses_b.shape != (CB, W * 240, 135) \
            or not np.isfinite(poses_b).all():
        raise SystemExit(f"serve_batch shapes {codes_b.shape} "
                         f"{poses_b.shape} or non-finite poses")
    feats = server.encode(wav.reshape(CB * W, -1))
    S = server.n_steps
    ta_h = stage_test_audio(s_cfg, s_db, wavlm=feats.cpu().numpy())
    tc_h = stage_test_context(s_db, ctx.reshape((CB * W,) + ctx.shape[2:]))
    want = s_engine.predict_batch(ta_h.reshape(CB, W, S, -1),
                                  tc_h.reshape(CB, W, S, -1),
                                  init_codes=zeros_c, init_phases=zeros_p)
    for c in range(CB):
        if not np.array_equal(codes_b[c], want[c].codes):
            raise SystemExit(f"serve_batch clip {c} differs from "
                             f"predict_batch over host staging of the "
                             f"card's batched features")
    solo_codes = shipped["codes"] + [serve_solo(c)[0]
                                     for c in range(N_REQUESTS, CB)]
    same = np.stack(solo_codes) == codes_b
    feat_diff = max(float((server.encode(wav[c]) - feats[c * W:(c + 1) * W])
                          .abs().max()) for c in range(CB))
    batch_ms = median_ms(serve_batch, 3, warmup=0)
    seq_ms = median_ms(lambda: [serve_solo(c) for c in range(CB)], 2,
                       warmup=0)
    log(f"phase 11 shipped serve_batch C={CB} W={W} (encoder batch "
        f"{CB * W}): codes == predict_batch over host staging of the card's "
        f"batched features; K2 launches {k2_launches}; against solo serve "
        f"(phase 7's codes): index_agreement {same.mean():.4f} "
        f"({int(same.sum())}/{same.size}), clips_identical "
        f"{int(same.all(axis=(1, 2)).sum())}/{CB}, batched vs solo features "
        f"max_abs_diff {feat_diff:.3e}; batch_ms={batch_ms:.3f} "
        f"({1e3 * CB / batch_ms:.2f} clips/s) vs {CB} sequential serve "
        f"{seq_ms:.3f} ms ({1e3 * CB / seq_ms:.2f} clips/s), "
        f"x{seq_ms / batch_ms:.2f}")
    kernels = log_profile("phase 11 shipped serve_batch", serve_batch)
    k2 = [(us, n) for key, (us, n) in kernels.items()
          if "gated_flash_kernel_f32" in key]
    if k2:
        log(f"phase 11 K2 at B={CB * W} in the profiled batch: {k2[0][1]} "
            f"launches, {k2[0][0] / k2[0][1] / 1e3:.5f} ms per launch")
    return k1_launches, k2_launches, dict(
        ta=ta, tc=tc, inits=inits, phases=phases0, codes=got, server=server,
        wav=wav, ctx=ctx, solo_codes=solo_codes)


def phase_streaming(dev, serving, staged):
    """Streaming: a StreamingPool of C_STAGED staged wavvq streams and a
    StreamingRawWavPool of C_RAW shipped raw-wav streams, W ticks each,
    stream by stream against solo sessions; idle streams, reset_stream,
    and no host sync in a tick or a push. Returns (K1, K2 launches)."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.serve import (StreamingPool,
                                           StreamingRawWavPool,
                                           StreamingRawWavSession,
                                           StreamingSession)

    def no_sync(fn):
        """fn() with torch's sync debug mode raising on any call that
        waits for the card; the result is downloaded afterwards."""
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return out.cpu().numpy()

    # -- staged wavvq pool -------------------------------------------------
    engine = serving.engine
    ta, tc, C = staged["ta"], staged["tc"], C_STAGED
    inits, phases0 = staged["inits"], staged["phases"]
    rngs = [np.random.RandomState(100 + i) for i in range(C)]
    pool = StreamingPool(engine, C, init_codes=inits, init_phases=phases0,
                         rngs=rngs)
    torch.cuda.synchronize()
    K1.launches = K2.launches = 0
    rows, tick_ms = [], []
    for w in range(W):
        t0 = time.perf_counter()
        rows.append(pool.tick(ta[:, w], tc[:, w]))
        tick_ms.append(1e3 * (time.perf_counter() - t0))
    k1_launches = K1.launches
    got = np.stack(rows, 1)                                   # (C, W, 30)
    for i in range(C):
        sess = StreamingSession(engine, init_code=int(inits[i]),
                                init_phase=phases0[i],
                                rng=np.random.RandomState(100 + i))
        solo = np.stack([sess.push_window(ta[i, w], tc[i, w])
                         for w in range(W)])
        if not (np.array_equal(got[i], solo)
                and np.array_equal(got[i], staged["codes"][i].codes)):
            raise SystemExit(f"StreamingPool stream {i} differs from a solo "
                             f"session or from phase 11's batch")
    # an idle stream keeps its seeds; reset_stream re-seeds a slot
    before = [x.clone() for x in pool.state()]
    active = np.ones(C, bool)
    active[3] = False
    pool.tick(ta[:, 0], tc[:, 0], active=active)
    after = pool.state()
    if not all(torch.equal(b[3], a[3]) for b, a in zip(before, after)):
        raise SystemExit("an idle stream's seeds changed")
    zero = np.zeros((8, 16), np.float32)
    pool.reset_stream(5, init_code=17, init_phase=zero,
                      rng=np.random.RandomState(7))
    fresh = StreamingSession(engine, init_code=17, init_phase=zero,
                             rng=np.random.RandomState(7))
    if not np.array_equal(pool.tick(ta[:, 1], tc[:, 1])[5],
                          fresh.push_window(ta[5, 1], tc[5, 1])):
        raise SystemExit("reset_stream did not re-seed the slot")
    no_sync(lambda: pool.tick_device(ta[:, 2], tc[:, 2], active=active))
    no_sync(lambda: fresh.push_window_device(ta[5, 2], tc[5, 2]))
    tick_p50 = statistics.median(tick_ms)
    log(f"phase 12 wavvq StreamingPool {C} streams x {W} ticks: every "
        f"stream == a solo StreamingSession == phase 11's lane; an idle "
        f"stream kept its seeds, reset_stream re-seeded a slot; a tick and "
        f"a push ran under sync debug mode \"error\"; K1 launches "
        f"{k1_launches}; tick p50 {tick_p50:.3f} ms ({C} streams)")

    # -- shipped raw-wav pool ------------------------------------------------
    server, wav, ctx, CB = staged["server"], staged["wav"], staged["ctx"], \
        C_RAW
    seed = server.engine.cfg.seed
    zeros_c = np.zeros(CB, np.int32)
    zeros_p = np.zeros((CB, 8, 16), np.float32)
    rpool = StreamingRawWavPool(server, CB, init_codes=zeros_c,
                                init_phases=zeros_p,
                                rngs=[np.random.RandomState(seed)
                                      for _ in range(CB)])
    torch.cuda.synchronize()
    K1.launches = K2.launches = 0
    rows, tick_ms = [], []
    for w in range(W):
        t0 = time.perf_counter()
        rows.append(rpool.tick(wav[:, w], ctx[:, w]))
        tick_ms.append(1e3 * (time.perf_counter() - t0))
    k2_launches = K2.launches
    layers = server.encoder.cfg.encoder_layers
    if k2_launches != W * layers:
        raise SystemExit(f"the raw pool launched K2 {k2_launches} times")
    got = np.stack(rows, 1)
    for i in range(CB):
        sess = StreamingRawWavSession(server, init_code=0, init_phase=zero,
                                      rng=np.random.RandomState(seed))
        solo = np.stack([sess.push_wav(wav[i, w], ctx[i, w])
                         for w in range(W)])
        if not np.array_equal(got[i], solo):
            raise SystemExit(f"StreamingRawWavPool stream {i} differs from "
                             f"a solo StreamingRawWavSession")
        if not np.array_equal(solo, staged["solo_codes"][i]):
            raise SystemExit(f"solo StreamingRawWavSession {i} differs from "
                             f"RawWavServer.serve over the same windows")
    no_sync(lambda: rpool.tick_device(wav[:, 0], ctx[:, 0]))
    no_sync(lambda: sess.push_wav_device(wav[0, 0], ctx[0, 0]))
    log(f"phase 12 shipped StreamingRawWavPool {CB} streams x {W} ticks: "
        f"every stream == a solo StreamingRawWavSession == RawWavServer."
        f"serve over the same windows; a raw tick and a raw "
        f"push ran under sync debug mode \"error\"; K2 launches "
        f"{k2_launches} ({layers} per tick); tick p50 "
        f"{statistics.median(tick_ms):.3f} ms ({CB} streams, encoder batch "
        f"{CB})")
    return k1_launches, k2_launches


def phase_high(dev, shipped, vqvae_gpu, data_mean, data_std):
    """Raw-wav serving of the shipped preset with the encoder at
    precision="high" (bf16x3 GEMMs, K2 in float32), on phase 7's weights
    and requests. Returns K2 launches."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.match.database import (stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.models.wavlm import WavLM
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.serve import RawWavServer, ServingPipeline

    cfg, db, wavs, ctxs = (shipped["cfg"], shipped["db"], shipped["wavs"],
                           shipped["ctxs"])
    wcfg = dataclasses.replace(shipped["enc_cpu"].cfg, precision="high")
    enc_gpu = WavLM(wcfg, device=dev)
    enc_gpu.load_state_dict(shipped["enc_gpu"].state_dict())
    server = RawWavServer(shipped["engine"], vqvae_gpu, enc_gpu, data_mean,
                          data_std)

    def serve(r):
        return server.serve(wavs[r], ctxs[r], init_code=0,
                            rng=np.random.RandomState(cfg.seed))

    serve(N_REQUESTS)                   # warm-up request
    torch.cuda.synchronize()
    K2.launches = 0
    served, req_ms = [], []
    for r in range(N_REQUESTS):
        t0 = time.perf_counter()
        served.append(serve(r))
        req_ms.append(1e3 * (time.perf_counter() - t0))
    k2_launches = K2.launches
    if k2_launches != N_REQUESTS * wcfg.encoder_layers:
        raise SystemExit(f"\"high\" requests launched K2 {k2_launches} "
                         f"times")
    pipe = ServingPipeline(shipped["engine"], vqvae_gpu, data_mean, data_std)
    n_same = n_clips_same = 0
    for r, (codes_r, poses_r) in enumerate(served):
        feats = server.encode(wavs[r])
        want, _ = pipe.serve(stage_test_audio(cfg, db,
                                              wavlm=feats.cpu().numpy()),
                             stage_test_context(db, ctxs[r]), init_code=0,
                             rng=np.random.RandomState(cfg.seed))
        if not np.array_equal(codes_r, want) or \
                not np.isfinite(poses_r).all():
            raise SystemExit(f"\"high\" request {r}: codes differ from "
                             f"host-staged serving of the card's features")
        same = codes_r == shipped["codes"][r]
        n_same += int(same.sum())
        n_clips_same += int(same.all())
    agreement = n_same / (N_REQUESTS * W * 30)

    t0 = time.time()
    enc_cpu = WavLM(wcfg, device="cpu")
    enc_cpu.load_state_dict(shipped["enc_cpu"].state_dict())
    x = torch.as_tensor(wavs[0][:2]).float() / 32768.0
    err = float((enc_gpu(x.to(dev)).cpu() - enc_cpu(x)).abs().max())
    del enc_cpu
    vs_highest = float((server.encode(wavs[0]) - shipped["feats"])
                       .abs().max())
    encoder_ms = median_ms(lambda: server.encode(wavs[0]), 5, warmup=1)
    log(f"phase 13 \"high\" serve p50 {statistics.median(req_ms):.3f} ms over"
        f" {N_REQUESTS} requests; K2 launches {k2_launches} (float32); codes "
        f"== host-staged serving of the card's \"high\" features; against "
        f"phase 7's \"highest\" codes: index_agreement {agreement:.4f} "
        f"({n_same}/{N_REQUESTS * W * 30}), clips_identical "
        f"{n_clips_same}/{N_REQUESTS}; card \"high\" vs \"highest\" features "
        f"max_abs_diff {vs_highest:.3e}; card vs CPU port \"high\", request "
        f"0 windows 0-1: max_abs_err {err:.3e} (tol {FEAT_ATOL}, "
        f"{time.time() - t0:.1f} s); encoder_ms={encoder_ms:.4f}")
    if not err <= FEAT_ATOL:
        raise SystemExit("card \"high\" features differ from the CPU port's")
    log_profile("phase 13", lambda: serve(0))
    return k2_launches


def transcript(rng, seconds: float):
    """A synthetic transcript: [(start_s, end_s, word)], ~2.7 words/s."""
    vocab = ("so the idea is that we move our hands when we speak and this "
             "motion follows the rhythm of the words you can see it here "
             "right now because every gesture has a beat").split()
    words, t = [], rng.uniform(0.0, 0.3)
    while t < seconds - 0.2:
        d = rng.uniform(0.12, 0.45)
        words.append((round(t, 3), round(min(t + d, seconds), 3),
                      vocab[rng.randint(len(vocab))]))
        t += d + rng.uniform(0.02, 0.25)
    return words


def write_minilm_dir(path: str, words) -> int:
    """A full-width random MiniLM (seeded) saved as a checkpoint directory
    with a vocabulary holding the transcript's words. Returns its parameter
    count."""
    import torch
    from qpgesture_tpu_torch.models.minilm import MiniLM, MiniLMConfig
    mcfg = MiniLMConfig()
    torch.manual_seed(SEED)
    model = MiniLM(mcfg, device="cpu")
    n_params = sum(p.numel() for p in model.parameters())
    torch.save(model.state_dict(), os.path.join(path, "pytorch_model.bin"))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += sorted({w for _, _, w in words})
    vocab += [f"filler{i}" for i in range(mcfg.vocab_size - len(vocab))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({}, f)                   # paraphrase-MiniLM-L6-v2's
    return n_params


def phase_transcript(dev, rng, shipped, server):
    """Transcript ingress: a full-width random MiniLM written with
    torch.save and read back by load_minilm; TranscriptContextStager
    stages a 24 s transcript that feeds RawWavServer.serve of the shipped
    preset. Returns K2 launches."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.match.database import (stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.models.minilm import MiniLMConfig, load_minilm
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.pipelines.database_builder import context_slots
    from qpgesture_tpu_torch.serve import (ServingPipeline,
                                           TranscriptContextStager)

    words = transcript(rng, W * 4.0)
    mcfg = MiniLMConfig()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        n_params = write_minilm_dir(tmp, words)
        enc_gpu = load_minilm(tmp, device=dev)
        enc_cpu = load_minilm(tmp, device="cpu")
    stager = TranscriptContextStager(enc_gpu)
    ctx = stager.stage(words, W)
    torch.cuda.synchronize()
    log(f"phase 14 set-up: MiniLM {n_params} parameters ({mcfg.num_layers} "
        f"layers, D={mcfg.hidden_size}, vocab {mcfg.vocab_size}) through "
        f"torch.save and load_minilm; transcript of {len(words)} words over "
        f"{W * 4} s; {time.time() - t0:.1f} s")
    ctx_cpu = TranscriptContextStager(enc_cpu).stage(words, W)
    err = float(np.abs(ctx - ctx_cpu).max())
    n_texts = len({t for w in range(W) for t in context_slots(
        words, 4.0 * w, 4.0 * w + 4.0)})
    stage_ms = median_ms(lambda: stager.stage(words, W), 3, warmup=0)
    if ctx.shape != (W, 30, mcfg.hidden_size) or not err <= MINILM_ATOL:
        raise SystemExit(f"MiniLM context {ctx.shape}: card vs CPU "
                         f"max_abs_err {err:.3e}")

    cfg, db, wav = shipped["cfg"], shipped["db"], shipped["wavs"][0]
    K2.launches = 0
    codes, poses = server.serve(wav, ctx, init_code=0,
                                rng=np.random.RandomState(cfg.seed))
    k2_launches = K2.launches
    feats = server.encode(wav).cpu().numpy()
    want, _ = ServingPipeline(server.engine, server.model).serve(
        stage_test_audio(cfg, db, wavlm=feats), stage_test_context(db, ctx),
        init_code=0, rng=np.random.RandomState(cfg.seed))
    if not np.array_equal(codes, want) or not np.isfinite(poses).all():
        raise SystemExit("transcript-staged codes differ from host-staged "
                         "serving of the card's context")
    same = codes == shipped["codes"][0]
    log(f"phase 14 TranscriptContextStager(MiniLMEncoder) on the card: "
        f"context {ctx.shape} of {n_texts} distinct slot texts, card vs CPU "
        f"port max_abs_err {err:.3e} (tol {MINILM_ATOL}); stage_ms="
        f"{stage_ms:.3f}; RawWavServer.serve with it: codes == host-staged "
        f"serving of the card's context, K2 launches {k2_launches}; codes "
        f"equal to phase 7's (random context) {int(same.sum())}/{same.size}")
    return k2_launches


def speech_like(rng, seconds: float):
    """16 kHz float32 speech-like audio: a voiced tone with vibrato, a
    syllable-rate envelope and noise."""
    import numpy as np
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 140 + 25 * np.sin(2 * np.pi * 0.7 * t)
    tone = np.sin(2 * np.pi * np.cumsum(f0) / 16000)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * t) ** 2
    return (0.25 * env * tone + 0.01 * rng.randn(t.size)).astype(np.float32)


def write_recordings(root: str, rng):
    """REC_NAMES as BEAT-like files under root: bvh/ (the 15-target-joint
    skeleton at 120 fps, smooth motion), wav/ (16 kHz PCM16) and txt/ (tab
    transcripts). Returns (the three directories, every word written)."""
    from qpgesture_tpu_torch.pipelines.audio_prep import write_wav
    from qpgesture_tpu_torch.pipelines.transcripts import write_tab_transcript
    dirs = {k: os.path.join(root, k) for k in ("bvh", "wav", "txt")}
    for d in dirs.values():
        os.makedirs(d)
    all_words = []
    for name in REC_NAMES:
        with open(os.path.join(dirs["bvh"], name + ".bvh"), "w") as f:
            f.write(skeleton_bvh_text(rng, int(REC_SECONDS * 120),
                                      smooth=True))
        write_wav(os.path.join(dirs["wav"], name + ".wav"),
                  speech_like(rng, REC_SECONDS), 16000)
        words = transcript(rng, REC_SECONDS)
        write_tab_transcript(os.path.join(dirs["txt"], name + ".txt"), words)
        all_words += words
    return dirs, all_words


def read_recordings(dirs, workdir: str):
    """The recordings as build-db reads them, in its order: [(name, BVH,
    float32 16 kHz wav, words)]."""
    import glob

    import numpy as np
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    from qpgesture_tpu_torch.pipelines.audio_prep import (ensure_16k_wav,
                                                          read_wav)
    from qpgesture_tpu_torch.pipelines.transcripts import read_tab_transcript
    out = []
    for path in sorted(glob.glob(os.path.join(dirs["bvh"], "*.bvh"))):
        name = os.path.splitext(os.path.basename(path))[0]
        wav, _ = read_wav(ensure_16k_wav(
            os.path.join(dirs["wav"], name + ".wav"), workdir))
        out.append((name, parse_bvh(path), wav.astype(np.float32),
                    read_tab_transcript(os.path.join(dirs["txt"],
                                                     name + ".txt"))))
    return out


def circular_err(got, want):
    """Per-element distance of two phase arrays on the unit circle."""
    import numpy as np
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)) % 1
    return np.minimum(d, 1 - d)


def check_codes(name: str, vq_gpu, norm, got, want) -> None:
    """VQ codes of the card against the CPU port's. Where they differ, the
    two candidates' squared distances from the card's latent are compared:
    a flip is accepted only between candidates whose distances differ by
    float32 rounding (relative to the terms the distance sums)."""
    import numpy as np
    import torch
    diff = np.argwhere(got != want)
    gaps = []
    for n, t in diff:
        with torch.no_grad():
            h = vq_gpu.encoders[0](torch.as_tensor(
                norm[n:n + 1].astype(np.float32), device=vq_gpu.device))
        x = h[0, t].double().cpu().numpy()
        k = vq_gpu.codebook.double().cpu().numpy()
        a, b = k[got[n, t]], k[want[n, t]]
        da, db = ((x - a) ** 2).sum(), ((x - b) ** 2).sum()
        scale = (x ** 2).sum() + max((a ** 2).sum(), (b ** 2).sum())
        gaps.append(abs(da - db) / scale)
        log(f"phase 15 {name} code differs at window {n} slot {t}: card "
            f"{got[n, t]} vs CPU {want[n, t]}, distance gap {da - db:+.3e} "
            f"(relative {gaps[-1]:.3e}, tol {CODE_GAP_RTOL})")
    if gaps and max(gaps) > CODE_GAP_RTOL:
        raise SystemExit(f"{name}: card codes differ from the CPU port's by "
                         f"more than float32 rounding")
    log(f"phase 15 {name} codes: {got.size - len(diff)}/{got.size} equal to "
        f"the CPU port's")


def phase_build(dev, rng, shipped, vqvae_cpu, tmp: str):
    """Database construction on the card from four full-size BEAT-like
    recordings, with the library functions build-db calls, each held
    against the CPU port; then the built database served. Returns what the
    CLI part needs. The launches of this part are read by the caller."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.core.config import MATCH_PRESETS, PAEConfig
    from qpgesture_tpu_torch.core.schemas import CodebookSignature
    from qpgesture_tpu_torch.match.database import (stage_database,
                                                    stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.match.engine import CodeKNNEngine
    from qpgesture_tpu_torch.models.pae import PAE, PhaseExtractor
    from qpgesture_tpu_torch.models.vq_wav2vec import VQWav2Vec
    from qpgesture_tpu_torch.models.vqvae import codebook_signature
    from qpgesture_tpu_torch.motion.pipeline import MotionPipeline
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.ops.mfcc import MFCCConfig, sphinx_mfcc_np
    from qpgesture_tpu_torch.pipelines import database_builder as builder
    from qpgesture_tpu_torch.pipelines.audio_host import get_energy
    from qpgesture_tpu_torch.pipelines.pitch_world import get_pitch_world
    from qpgesture_tpu_torch.serve import RawWavServer, ServingPipeline
    from qpgesture_tpu_torch.train.data import dataset_stats

    def seconds(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    # -- recordings on disk, read back as build-db reads them ---------------
    t0 = time.time()
    dirs, words = write_recordings(os.path.join(tmp, "rec"), rng)
    minilm_dir = os.path.join(tmp, "minilm")
    os.makedirs(minilm_dir)
    write_minilm_dir(minilm_dir, words)
    inputs = read_recordings(dirs, os.path.join(tmp, "_audio16k"))
    log(f"phase 15 set-up: {len(inputs)} recordings of {REC_SECONDS:.0f} s "
        f"(BVH at 120 fps, 16 kHz wav, {len(words)} transcript words), "
        f"MiniLM directory; {time.time() - t0:.1f} s")

    # -- host features (step 2) ----------------------------------------------
    pipeline = MotionPipeline(fps=60).fit(inputs[0][1])
    recs, host_s = seconds(lambda: [
        builder.process_recording(name, bvh, wav, pipeline, w)
        for name, bvh, wav, w in inputs])
    wav0 = inputs[0][2]
    _, pitch_s = seconds(lambda: get_pitch_world(wav0, log=True, norm=False))
    _, mfcc_s = seconds(lambda: sphinx_mfcc_np(wav0, MFCCConfig(frate=60)))
    _, energy_s = seconds(lambda: get_energy(wav0))
    mean, std = dataset_stats([{"poses": r.rotation} for r in recs])
    n_frames = sum(len(r.rotation) for r in recs)
    log(f"phase 15 host: process_recording x{len(recs)} {1e3 * host_s:.1f} "
        f"ms ({n_frames} frames at 60 fps); one {REC_SECONDS:.0f} s "
        f"recording: host_ms pitch={1e3 * pitch_s:.1f} "
        f"mfcc={1e3 * mfcc_s:.1f} energy={1e3 * energy_s:.1f}")

    # -- PAE phases on the card ------------------------------------------------
    torch.manual_seed(SEED + 2)
    pae_cpu = PAE(PAEConfig(), device="cpu")
    pae_gpu = copy.deepcopy(pae_cpu).to(dev)
    extractor = PhaseExtractor(pae_gpu, device=dev)
    extractor.pose_to_phase(recs[0].rotation[:300], mean, std)   # warm-up
    torch.cuda.synchronize()
    phases, phase_s = seconds(lambda: [
        extractor.pose_to_phase(r.rotation, mean, std) for r in recs])
    for rec, ph in zip(recs, phases):
        rec.phase = ph
    cpu_ex = PhaseExtractor(pae_cpu, device="cpu")
    worst = {k: (0.0, 0) for k in "pfab"}       # (max error, channel)
    t0 = time.time()
    R = PHASE_CHECK_ROWS
    for rec in recs:
        vel = cpu_ex.velocity(rec.rotation, mean, std)
        T = len(rec.rotation)
        # both padded edges, and the seam of the first two batches of 1024
        for a in (0, min(1024, T // 2) - R // 2, T - R):
            want = cpu_ex.phases_at(vel, a, a + R).numpy()
            got = rec.phase[a:a + R]
            errs = [circular_err(got[:, 0], want[:, 0])] + [
                np.abs(got[:, i] - want[:, i]) for i in (1, 2, 3)]
            for key, e in zip("pfab", errs):
                m = float(e.max())
                if m > worst[key][0]:
                    worst[key] = (m, int(e.max(axis=0).argmax()))
    f_scale = float(np.abs(np.stack([r.phase[:, 1] for r in recs])).max())
    log(f"phase 15 PAE: phase_ms={1e3 * phase_s:.2f} for {n_frames} frames "
        f"({n_frames / phase_s:.0f} frames/s, one stride-1 window each, "
        f"batch 1024); card vs CPU port on {3 * R} rows of each recording: "
        + ", ".join(f"{k} max_abs_err {v:.3e} (channel {c})"
                    for k, (v, c) in worst.items())
        + f" (tol {PHASE_ATOL}, p on the circle; frequency scale "
          f"{f_scale:.3f}); check {time.time() - t0:.1f} s")
    if max(v for v, _ in worst.values()) > PHASE_ATOL:
        raise SystemExit("card PAE phases differ from the CPU port's")
    log_profile("phase 15 PAE extraction",
                lambda: extractor.pose_to_phase(recs[0].rotation, mean, std))

    # -- windows with MiniLM context on the card -------------------------------
    embed = builder.minilm_embed_fn(minilm_dir, device=dev)
    splits = {"train": [], "validation": [], "test": []}
    for rec in recs:
        splits[builder.split_of(rec.name)].append(rec)
    bundles, window_s = seconds(lambda: {
        s: builder.window_recordings(r, embed_fn=embed)
        for s, r in splits.items()})
    ref = builder.window_recordings(
        splits["test"], embed_fn=builder.minilm_embed_fn(minilm_dir,
                                                         device="cpu"))
    ctx_err = float(np.abs(bundles["test"].context - ref.context).max())
    log(f"phase 15 windows: " + ", ".join(
        f"{s} {b.body.shape[0]}" for s, b in bundles.items())
        + f" (train {[r.name for r in splits['train']]}); window + MiniLM "
          f"context {1e3 * window_s:.1f} ms; test context card vs CPU port "
          f"max_abs_err {ctx_err:.3e} (tol {MINILM_ATOL})")
    if not ctx_err <= MINILM_ATOL:
        raise SystemExit("card MiniLM context differs from the CPU port's")

    # -- VQ-VAE codes and the codebook signature ------------------------------
    vq_cpu = copy.deepcopy(vqvae_cpu)
    clip_std = np.clip(std, 0.01, None)
    norm = {s: (b.body - mean) / clip_std for s, b in bundles.items()}
    # the codebook from the built windows' latents, as training starts
    vq_cpu.init_codebook_from_batch(torch.as_tensor(
        norm["train"][:32].astype(np.float32)), rng)
    vq_gpu = copy.deepcopy(vq_cpu).to(dev)
    for b in bundles.values():                  # warm-up at the timed shapes
        builder.encode_windows(vq_gpu, b.body, mean, std)
    codebook_signature(vq_gpu, mean, std)
    codes, encode_s = seconds(lambda: {
        s: builder.encode_windows(vq_gpu, b.body, mean, std)
        for s, b in bundles.items()})
    for s, b in bundles.items():
        check_codes(f"encode_windows {s}", vq_gpu, norm[s], codes[s],
                    builder.encode_windows(vq_cpu, b.body, mean, std))
    (sig_code, sig_poses, sig), signature_s = seconds(
        lambda: codebook_signature(vq_gpu, mean, std))
    t0 = time.time()
    c_cpu, p_cpu, s_cpu = codebook_signature(vq_cpu, mean, std)
    sig_err = max(float(np.abs(sig_poses - p_cpu).max()),
                  float(np.abs(sig - s_cpu).max()))
    log(f"phase 15 encode_ms={1e3 * encode_s:.2f} ({sum(len(c) for c in codes.values())}"
        f" windows, batch 64); signature_ms={1e3 * signature_s:.2f} "
        f"(512 codes x 240 frames decoded); signature card vs CPU port "
        f"max_abs_err {sig_err:.3e} (tol {SIGNATURE_ATOL}); CPU "
        f"{time.time() - t0:.1f} s; distinct train codes "
        f"{len(np.unique(codes['train']))}")
    if not (np.array_equal(sig_code, c_cpu) and sig_err <= SIGNATURE_ATOL):
        raise SystemExit("card codebook signature differs from the CPU port's")
    signature = CodebookSignature(code=sig_code, poses=sig_poses,
                                  signature=sig)

    # -- WavLM-Large features (K2 f32 at B=8) and vq-wav2vec codes -------------
    enc_gpu, enc_cpu = shipped["enc_gpu"], shipped["enc_cpu"]
    layers = enc_gpu.cfg.encoder_layers
    builder.extract_wavlm(enc_gpu, bundles["test"].wav)   # warm-up, B=8 and 7
    before = K2.launches
    feats, wavlm_s = seconds(lambda: {
        s: builder.extract_wavlm(enc_gpu, b.wav) for s, b in bundles.items()})
    want_launches = layers * sum(-(-len(b.wav) // 8)
                                 for b in bundles.values())
    if K2.launches - before != want_launches:
        raise SystemExit(f"extract_wavlm launched K2 {K2.launches - before} "
                         f"times, not {want_launches}")
    t0 = time.time()         # the CPU port on the test split's first batch
    feat_err = float(np.abs(feats["test"][:8] - builder.extract_wavlm(
        enc_cpu, bundles["test"].wav[:8])).max())
    n_win = sum(len(b.wav) for b in bundles.values())
    log(f"phase 15 wavlm_ms={1e3 * wavlm_s:.2f} ({n_win} windows at batch 8"
        f", {want_launches} K2 launches); test windows 0-7 card vs CPU port "
        f"max_abs_err {feat_err:.3e} (tol {FEAT_ATOL}), CPU "
        f"{time.time() - t0:.1f} s")
    if not feat_err <= FEAT_ATOL:
        raise SystemExit("card WavLM features differ from the CPU port's")
    torch.manual_seed(SEED + 3)
    wavvq_cpu = VQWav2Vec(device="cpu")
    wavvq_gpu = copy.deepcopy(wavvq_cpu).to(dev)
    wavvq, wavvq_s = seconds(lambda: {
        s: builder.extract_wavvq(wavvq_gpu, b.wav)
        for s, b in bundles.items()})
    log(f"phase 15 vq-wav2vec {1e3 * wavvq_s:.2f} ms ({n_win} windows)")

    # -- serve the built database's test split -------------------------------
    train, test = bundles["train"], bundles["test"]
    wav, ctx = test.wav[:W], test.context[:W]
    served = {}
    for preset, encoder, kw in (("shipped", enc_gpu, {"wavlm": feats}),
                                ("wavvq", wavvq_gpu, {"wavvq": wavvq})):
        cfg = MATCH_PRESETS[preset]
        key = next(iter(kw))
        db = stage_database(cfg, train, codes["train"], signature,
                            **{key: kw[key]["train"]})
        server = RawWavServer(CodeKNNEngine(cfg, db, device=dev), vq_gpu,
                              encoder, mean, std)
        b1, b2 = K1.launches, K2.launches
        (got, poses), serve_s = seconds(lambda: server.serve(
            wav, ctx, init_code=0, rng=np.random.RandomState(cfg.seed)))
        n1, n2 = K1.launches - b1, K2.launches - b2
        if (preset == "shipped" and n2 != layers) or \
                (preset == "wavvq" and n1 < 1):
            raise SystemExit(f"{preset} request on the built database "
                             f"launched K1 {n1}, K2 {n2} times")
        enc = server.encode(wav).cpu().numpy()
        want, _ = ServingPipeline(CodeKNNEngine(cfg, db, device="cpu"),
                                  vq_cpu).serve(
            stage_test_audio(cfg, db, **{key: enc}),
            stage_test_context(db, ctx), init_code=0,
            rng=np.random.RandomState(cfg.seed))
        if got.shape != (W, 30) or poses.shape != (W * 240, 135) or \
                not np.isfinite(poses).all() or not np.array_equal(got, want):
            raise SystemExit(f"{preset} request on the built database: "
                             f"codes differ from the CPU port's engine")
        served[preset] = got
        log(f"phase 15 served the built database ({preset}, J="
            f"{len(train.body)} train windows with their PAE phases, "
            f"request of the test split's first {W} windows): "
            f"{1e3 * serve_s:.1f} ms, codes == the CPU port's engine over the "
            f"same staged inputs; K1 launches {n1}, K2 launches {n2}; "
            f"distinct codes {len(np.unique(got))}")
    return dict(dirs=dirs, minilm_dir=minilm_dir, recs=recs,
                pipeline=pipeline, mean=mean, std=std, bundles=bundles,
                codes=codes, wavvq=wavvq, pae_cpu=pae_cpu,
                extractor=extractor, vq_cpu=vq_cpu, vq_gpu=vq_gpu,
                wavvq_cpu=wavvq_cpu, wavvq_gpu=wavvq_gpu)


def phase_build_clis(dev, built, enc_cpu, tmp: str) -> None:
    """The database CLIs on the card (build-db, phase, signature,
    test-audio, warmup; assemble-beat on the host) on checkpoints written
    to disk, each file held against the library call on the same inputs:
    host arrays, codes and vq-wav2vec codes exactly, device floats within
    the card-vs-CPU tolerances (their bit-equality is logged)."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch
    import yaml
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.config import load_config
    from qpgesture_tpu_torch.core.schemas import (CodebookSignature,
                                                  DatabaseBundle)
    from qpgesture_tpu_torch.models.vqvae import codebook_signature
    from qpgesture_tpu_torch.models.wavlm import load_wavlm_checkpoint
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.pipelines import database_builder as builder
    from qpgesture_tpu_torch.pipelines.audio_prep import load_wav_16k

    p = lambda *names: os.path.join(tmp, *names)
    notes = []

    def close(name, got, want, atol):
        """Float outputs: within atol, with their bit-equality noted."""
        err = float(np.abs(np.asarray(got, np.float64)
                           - np.asarray(want, np.float64)).max())
        notes.append(f"{name} {'bit-equal' if np.array_equal(got, want) else f'max_abs_err {err:.3e}'}")
        if got.shape != want.shape or not err <= atol:
            raise SystemExit(f"CLI {name} differs from the library call")

    def equal(name, got, want):
        if got.shape != want.shape or got.dtype != want.dtype or \
                not np.array_equal(got, want):
            raise SystemExit(f"CLI {name} differs from the library call")

    # -- checkpoints: the build's PAE, VQ-VAE and vq-wav2vec; WavLM cut to 2
    t0 = time.time()
    os.makedirs(p("ck"))
    torch.save({"model_dict": {f"module.{k}": v for k, v in
                               built["pae_cpu"].state_dict().items()}},
               p("ck", "pae.pt"))
    torch.save({"model_dict": built["vq_cpu"].state_dict()},
               p("ck", "vqvae.bin"))
    torch.save({"model": built["wavvq_cpu"].state_dict()},
               p("ck", "wavvq.pt"))
    layers = 2
    wcfg = dataclasses.replace(enc_cpu.cfg, encoder_layers=layers)
    torch.save({"cfg": {k: v for k, v in dataclasses.asdict(wcfg).items()
                        if k != "conv_feature_layers"},
                "model": {k: v for k, v in enc_cpu.state_dict().items()
                          if not k.startswith("encoder.layers.")
                          or int(k.split(".")[2]) < layers}},
               p("ck", "wavlm2.pt"))
    mean, std = built["mean"], built["std"]
    with open(p("ck", "config.yml"), "w") as f:
        yaml.safe_dump({"data_mean": mean.tolist(),
                        "data_std": std.tolist()}, f)
    conf = load_config(p("ck", "config.yml"))
    mean64 = np.asarray(conf.data_mean).squeeze()
    std64 = np.asarray(conf.data_std).squeeze()
    dirs = built["dirs"]
    t_files = time.time() - t0

    # -- build-db ------------------------------------------------------------
    t0 = time.time()
    cli(["build-db", "--bvh-dir", dirs["bvh"], "--wav-dir", dirs["wav"],
         "--transcript-dir", dirs["txt"], "--out", p("db"),
         "--prefix", "smoke", "--config", p("ck", "config.yml"),
         "--pae-checkpoint", p("ck", "pae.pt"),
         "--vqvae-checkpoint", p("ck", "vqvae.bin"),
         "--wavvq-checkpoint", p("ck", "wavvq.pt"),
         "--wavlm-checkpoint", p("ck", "wavlm2.pt"),
         "--sentence-model", built["minilm_dir"], "--device", "cuda"])
    t_build = time.time() - t0
    with open(p("db", "pipeline.json")) as f:
        if f.read() != built["pipeline"].to_json():
            raise SystemExit("CLI pipeline.json differs from the library's")
    stats = np.load(p("db", "stats.npz"))
    equal("stats mean", stats["mean"], mean)
    equal("stats std", stats["std"], std)
    wavlm2 = load_wavlm_checkpoint(p("ck", "wavlm2.pt"), device=dev)
    for split, want in built["bundles"].items():
        stem = p("db", f"smoke_{split}_240")
        got = DatabaseBundle.load(f"{stem}_txt_2.npz")
        for field in ("body", "mfcc", "wav", "energy", "pitch", "volume"):
            equal(f"{split} {field}", getattr(got, field),
                  getattr(want, field))
        if [list(a) for a in got.aux] != [list(a) for a in want.aux]:
            raise SystemExit(f"CLI {split} aux differs from the library's")
        close(f"{split} phase", got.phase, want.phase, PHASE_ATOL)
        close(f"{split} context", got.context, want.context, MINILM_ATOL)
        equal(f"{split} codes", np.load(f"{stem}_code.npz")["code"],
              built["codes"][split])
        equal(f"{split} WavVQ", np.load(f"{stem}_WavVQ.npz")["wavvq"],
              built["wavvq"][split])
        close(f"{split} WavLM (2 layers)",
              np.load(f"{stem}_WavLM.npz")["wavlm"],
              builder.extract_wavlm(wavlm2, want.wav), FEAT_ATOL)
    del wavlm2

    # -- phase -----------------------------------------------------------------
    t0 = time.time()
    os.makedirs(p("rot"))
    for rec in built["recs"]:
        np.savez(p("rot", rec.name + ".npz"), upper=rec.rotation)
    cli(["phase", "--checkpoint", p("ck", "pae.pt"),
         "--config", p("ck", "config.yml"), "--rotation-dir", p("rot"),
         "--out", p("phase"), "--device", "cuda"])
    for rec in built["recs"]:
        close(f"phase {rec.name}", np.load(p("phase", rec.name + ".npz"))[
            "phase"], built["extractor"].pose_to_phase(
                rec.rotation, mean64, std64), PHASE_ATOL)
    t_phase = time.time() - t0

    # -- signature ------------------------------------------------------------
    t0 = time.time()
    cli(["signature", "--checkpoint", p("ck", "vqvae.bin"),
         "--config", p("ck", "config.yml"), "--out", p("code.npz"),
         "--device", "cuda"])
    got = CodebookSignature.load(p("code.npz"))
    want = codebook_signature(built["vq_gpu"], mean64, std64)
    equal("signature code", got.code, want[0])
    close("signature poses", got.poses, want[1], SIGNATURE_ATOL)
    close("signature", got.signature, want[2], SIGNATURE_ATOL)
    t_sig = time.time() - t0

    # -- test-audio --------------------------------------------------------
    t0 = time.time()
    test_name = next(r.name for r in built["recs"]
                     if builder.split_of(r.name) == "test")
    test_wav = os.path.join(dirs["wav"], test_name + ".wav")
    os.makedirs(p("test"))
    cli(["test-audio", "--wav", test_wav, "--out",
         p("test", "wavvq_240.npz"), "--wavvq-checkpoint",
         p("ck", "wavvq.pt"), "--device", "cuda"])
    windows = builder.window_test_audio(load_wav_16k(test_wav))
    equal("test-audio wav", np.load(p("test", "wav_240.npz"))["wav"],
          windows)
    equal("test-audio wavvq", np.load(p("test", "wavvq_240.npz"))["wavvq"],
          builder.extract_wavvq(built["wavvq_gpu"], windows))
    t_test = time.time() - t0

    # -- assemble-beat: an orig-BEAT tree with one broken Frames header and
    # one unpaired motion file -------------------------------------------
    t0 = time.time()
    os.makedirs(p("orig", "1"))
    names = [r.name for r in built["recs"]]
    for i, name in enumerate(names):
        shutil.copy(os.path.join(dirs["wav"], name + ".wav"), p("orig", "1"))
        with open(os.path.join(dirs["bvh"], name + ".bvh")) as f:
            text = f.read()
        if i == 0:
            n = int(REC_SECONDS * 120)
            text = text.replace(f"Frames: {n}\n", f"Frames: {n + 1}\n")
        with open(p("orig", "1", name + ".bvh"), "w") as f:
            f.write(text)
    shutil.copy(os.path.join(dirs["bvh"], names[0] + ".bvh"),
                p("orig", "1", "1_smoke_0_9_9.bvh"))
    cli(["assemble-beat", "--orig-root", p("orig"), "--out", p("beat")])
    for sub, src, ext in (("Motion", dirs["bvh"], ".bvh"),
                          ("Audio", dirs["wav"], ".wav")):
        if sorted(os.listdir(p("beat", sub))) != sorted(n + ext
                                                        for n in names):
            raise SystemExit(f"assemble-beat {sub}/ holds the wrong files")
        for name in names:
            with open(p("beat", sub, name + ext), "rb") as f, \
                    open(os.path.join(src, name + ext), "rb") as g:
                if f.read() != g.read():
                    raise SystemExit(f"assemble-beat {sub}/{name}{ext} "
                                     f"differs from its source")
    t_beat = time.time() - t0

    # -- warmup on the built database, both presets ------------------------
    t0 = time.time()
    db_files = ["--train-database", p("db", "smoke_train_240_txt_2.npz"),
                "--train-codebook", p("db", "smoke_train_240_code.npz"),
                "--codebook-signature", p("code.npz"),
                "--buckets", "1,2", "--device", "cuda"]
    out = io.StringIO()
    before = K1.launches
    with contextlib.redirect_stdout(out):
        cli(["warmup", *db_files, "--train-wavvq",
             p("db", "smoke_train_240_WavVQ.npz"), "--preset", "wavvq",
             "--decode", "--serving", "--checkpoint", p("ck", "vqvae.bin"),
             "--streams", "2"])
        cli(["warmup", *db_files, "--train-wavlm",
             p("db", "smoke_train_240_WavLM.npz"), "--preset", "shipped"])
    text = out.getvalue()
    for line in text.splitlines():
        log(f"phase 15 warmup | {line}")
    if text.count("warm: 2 bucket(s)") != 2 or K1.launches == before:
        raise SystemExit("warmup did not warm both presets")
    t_warm = time.time() - t0
    log(f"phase 15 CLIs on the card: build-db {t_build:.1f} s, phase "
        f"{t_phase:.1f} s, signature {t_sig:.1f} s, test-audio "
        f"{t_test:.1f} s, assemble-beat {t_beat:.1f} s, warmup "
        f"{t_warm:.1f} s (checkpoints {t_files:.1f} s); files == the "
        f"library calls' on the same inputs (host arrays, codes and "
        f"vq-wav2vec codes exactly); " + "; ".join(notes))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "qpgesture_tpu_torch")):
        print(f"chip_smoke: no qpgesture_tpu_torch package beside "
              f"{__file__}; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t_start = t_mark = time.time()

    def phase_wall(phase: str) -> None:
        nonlocal t_mark
        now = time.time()
        log(f"{phase} wall {now - t_mark:.1f} s")
        t_mark = now

    # -- phase 1: the card -------------------------------------------------
    smi = nvidia_smi("name,power.limit")
    sm_clock_hz = float(nvidia_smi("clocks.max.sm")) * 1e6
    props = torch.cuda.get_device_properties(0)
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}, {props.multi_processor_count} SMs, "
        f"max SM clock {sm_clock_hz / 1e6:.0f} MHz")

    from qpgesture_tpu_torch.core.config import MATCH_PRESETS, VQVAEConfig
    from qpgesture_tpu_torch.match import engine as eng
    from qpgesture_tpu_torch.match.database import (stage_database,
                                                    stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.models.vqvae import VQVAE
    from qpgesture_tpu_torch.ops import cuda_build
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.serve import ServingPipeline

    # -- phase 2: build, one nvcc per source, all at once -------------------
    t0 = time.time()
    cuda_build.build_all([K1.SOURCE, K2.SOURCE])
    log(f"phase 2 build: {K1.SOURCE} + {K2.SOURCE} "
        f"{time.time() - t0:.2f} s")
    phase_wall("phases 1-2")

    rng = np.random.RandomState(SEED)
    bundle, codes, signature, wavvq, clips = make_data(rng)
    cfg = MATCH_PRESETS["wavvq"]
    db = stage_database(cfg, bundle, codes, signature, wavvq=wavvq)
    requests = [(stage_test_audio(cfg, db, wavvq=wv),
                 stage_test_context(db, ctx)) for wv, ctx in clips]

    # -- phase 3: K1 against its plain version on the card ------------------
    dev = torch.device("cuda")
    q_main = torch.as_tensor(requests[0][0].reshape(-1, 11), device=dev)
    b_main = torch.as_tensor(db.aud_strings.reshape(-1, 11), device=dev)
    gen = torch.Generator().manual_seed(SEED)

    def rand_strings(n, vocab, L=11):
        return torch.randint(0, vocab, (n, L), generator=gen,
                             dtype=torch.int32).to(dev)

    sum_q = stage_test_audio(dataclasses.replace(cfg, wavvq_mode="sum"), db,
                             wavvq=clips[0][0]).reshape(-1, 2, 11)
    from qpgesture_tpu_torch.ops.levenshtein import split_wavvq_groups
    from qpgesture_tpu_torch.ops.stacking import stack_wavvq
    g0, g1 = split_wavvq_groups(stack_wavvq(wavvq)[:, db.geom.block_frame_idx])
    cases = [
        ("main path", q_main, b_main),
        ("ragged N (+37)", q_main, torch.cat((b_main, b_main[:37]))),
        ("vocab 4", rand_strings(48, 4), rand_strings(26624, 4)),
        ("sum group 0", torch.as_tensor(np.ascontiguousarray(sum_q[:, 0]),
                                        device=dev),
         torch.as_tensor(g0.reshape(-1, 11), device=dev)),
        ("sum group 1", torch.as_tensor(np.ascontiguousarray(sum_q[:, 1]),
                                        device=dev),
         torch.as_tensor(g1.reshape(-1, 11), device=dev)),
        ("whole corpus", q_main, rand_strings(425984, 102400)),
    ]
    max_err = 0
    for name, a, b in cases:
        got = K1.levenshtein_matrix(a, b)
        torch.cuda.synchronize()
        want = K1.levenshtein_matrix_plain(a, b)
        err = int((got - want).abs().max().item())
        max_err = max(max_err, err)
        log(f"phase 3 K1 {name}: Q={a.shape[0]} N={b.shape[0]} "
            f"max_abs_err={err} exact={torch.equal(got, want)}")
        if not torch.equal(got, want):
            raise SystemExit(f"K1 disagrees with its plain version: {name}")
    Q, N = q_main.shape[0], b_main.shape[0]
    kernel_ms = device_ms(lambda: K1.levenshtein_matrix(q_main, b_main), 50)
    # ~730 elementwise launches per call: n calls queued behind device_ms's
    # spin could fill the launch queue, so it is timed call by call (host
    # time included)
    plain_ms = median_ms(lambda: K1.levenshtein_matrix_plain(q_main, b_main),
                         5, warmup=1)
    kernel_call_ms = median_ms(lambda: K1.levenshtein_matrix(q_main, b_main),
                               50)
    bound_ms, bound_by = lev_bound(Q, N, 11, props.multi_processor_count,
                                   sm_clock_hz)
    log(f"phase 3 K1 times at Q={Q} N={N}: kernel_ms={kernel_ms:.5f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}); "
        f"one kernel call between two events, host time included: "
        f"{kernel_call_ms:.5f}")
    b_corpus = cases[-1][2]
    corpus_ms = device_ms(lambda: K1.levenshtein_matrix(q_main, b_corpus), 20)
    corpus_bound, _ = lev_bound(Q, b_corpus.shape[0], 11,
                                props.multi_processor_count, sm_clock_hz)
    log(f"phase 3 K1 times at Q={Q} N={b_corpus.shape[0]}: "
        f"kernel_ms={corpus_ms:.5f} bound_ms={corpus_bound:.5f}")
    del cases, b_corpus
    phase_wall("phase 3")

    # -- phase 4: host-staged wavvq serving ----------------------------------
    vq_cfg = VQVAEConfig()
    torch.manual_seed(SEED)
    model_cpu = VQVAE(vq_cfg, device="cpu")
    model_cpu.init_codebook_from_batch(
        torch.as_tensor(rng.randn(4, 240, vq_cfg.input_dim)
                        .astype(np.float32)), rng)
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    data_mean = rng.randn(vq_cfg.input_dim).astype(np.float32) * 0.1
    data_std = rng.rand(vq_cfg.input_dim).astype(np.float32) + 0.5
    t0 = time.time()
    serving = ServingPipeline(eng.CodeKNNEngine(cfg, db, device="cuda"),
                              model_gpu, data_mean, data_std)
    torch.cuda.synchronize()
    log(f"phase 4 staged engine on {dev}: {time.time() - t0:.2f} s")
    reference = ServingPipeline(eng.CodeKNNEngine(cfg, db, device="cpu"),
                                model_cpu, data_mean, data_std)
    serving.serve(*requests[-1])            # warm-up request
    torch.cuda.synchronize()

    K1.launches = K2.launches = 0
    served, req_ms = [], []
    for r in range(N_REQUESTS):
        before = K1.launches
        t0 = time.perf_counter()
        out = serving.serve(*requests[r])   # returns host arrays: synced
        req_ms.append(1e3 * (time.perf_counter() - t0))
        if K1.launches <= before:
            raise SystemExit(f"request {r} did not launch K1")
        served.append(out)
    k1_launches = K1.launches

    pose_err = 0.0
    for r, (codes_gpu, poses_gpu) in enumerate(served):
        codes_cpu, poses_cpu = reference.serve(*requests[r])
        if codes_gpu.shape != (W, 30) or poses_gpu.shape != (W * 240, 135):
            raise SystemExit(f"request {r}: shapes {codes_gpu.shape} "
                             f"{poses_gpu.shape}")
        if not np.isfinite(poses_gpu).all():
            raise SystemExit(f"request {r}: non-finite poses")
        if not np.array_equal(codes_gpu, codes_cpu):
            raise SystemExit(f"request {r}: card codes differ from CPU codes")
        err = float(np.abs(poses_gpu - poses_cpu).max())
        pose_err = max(pose_err, err)
        log(f"phase 4 request {r}: {req_ms[r]:.3f} ms, codes == CPU port, "
            f"pose max_abs_err {err:.3e} (tol {POSE_ATOL})")
        if err > POSE_ATOL:
            raise SystemExit(f"request {r}: poses differ by {err}")
    log(f"phase 4 serve p50 {statistics.median(req_ms):.3f} ms over "
        f"{N_REQUESTS} requests (W={W}, J={J}); K1 launches {k1_launches}")

    # per-stage device times of one request (not counted as launches)
    engine = serving.engine
    ta, tc = engine.stage_queries(*requests[0])
    S = ta.shape[1]
    state = {}

    def tables():
        state["t"] = eng._tables_impl(cfg, engine.devdb, ta, tc)

    def scan():
        return eng._fuse_scan_clips(cfg, S, 1, engine.dev, state["t"], None,
                                    np.eye(1, W * S, dtype=bool)[0],
                                    np.zeros(W * S, np.int32),
                                    np.zeros((W * S, 8, 16), np.float32))

    codes_flat = torch.as_tensor(served[0][0].reshape(1, -1), device=dev)
    tables_ms = median_ms(tables, 10)
    scan_ms = median_ms(scan, 5, warmup=1)
    decode_ms = median_ms(lambda: model_gpu.decode(codes_flat), 10)
    log(f"phase 4 stage times: tables_ms={tables_ms:.4f} "
        f"scan_ms={scan_ms:.4f} decode_ms={decode_ms:.4f}")
    log_profile("phase 4", lambda: serving.serve(*requests[0]))
    phase_wall("phase 4")

    # -- phase 5: match -> decode CLI --------------------------------------
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.schemas import (load_result, save_codes,
                                                  save_wavvq)
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    from qpgesture_tpu_torch.motion.pipeline import MotionPipeline
    with tempfile.TemporaryDirectory() as tmp:
        p = lambda name: os.path.join(tmp, name)
        t0 = time.time()
        dataclasses.replace(bundle, context=bundle.context[:J_CLI],
                            phase=bundle.phase[:J_CLI]).save(p("db.npz"))
        save_codes(p("codes.npz"), codes[:J_CLI])
        signature.save(p("code.npz"))
        save_wavvq(p("wavvq.npz"), wavvq[:J_CLI])
        save_wavvq(p("test_wavvq.npz"), clips[0][0])
        dataclasses.replace(bundle, context=clips[0][1],
                            phase=None).save(p("test.npz"))
        torch.save({"model_dict": model_cpu.state_dict()}, p("vqvae.bin"))
        pipe = MotionPipeline(fps=60).fit(parse_bvh(skeleton_bvh_text(rng)))
        with open(p("pipeline.json"), "w") as f:
            f.write(pipe.to_json())
        t1 = time.time()
        cli(["match", "--train-database", p("db.npz"),
             "--train-codebook", p("codes.npz"),
             "--codebook-signature", p("code.npz"),
             "--train-wavvq", p("wavvq.npz"),
             "--test-wavvq", p("test_wavvq.npz"),
             "--test-data", p("test.npz"), "--preset", "wavvq",
             "--out", p("result.npz")])
        result = load_result(p("result.npz"))
        cli(["decode", "--result", p("result.npz"),
             "--checkpoint", p("vqvae.bin"),
             "--pipeline", p("pipeline.json"), "--out", p("out"),
             "--prefix", "smoke"])
        bvh = parse_bvh(p(os.path.join("out", "smoke_generated.bvh")))
        positions = np.load(p(os.path.join("out", "smoke_generated.npy")))
        if result.shape != (W, 30) or result.max() >= 512:
            raise SystemExit(f"CLI result {result.shape} out of range")
        if bvh.values.shape != (W * 240, len(bvh.channel_names)) or \
                not np.isfinite(bvh.values).all() or \
                positions.shape != (W * 240, 16 * 3):
            raise SystemExit(f"CLI BVH {bvh.values.shape}, positions "
                             f"{positions.shape}")
        log(f"phase 5 CLI match -> decode: result {result.shape}, BVH "
            f"{bvh.values.shape} parsed back; J={J_CLI} database; files "
            f"{t1 - t0:.1f} s, commands {time.time() - t1:.2f} s")

    phase_wall("phase 5")

    # -- phase 6: K2 against its plain version on the card ------------------
    k2_line = phase_k2(dev)
    phase_wall("phase 6")

    # -- phase 7: raw-wav serving, shipped preset, WavLM-Large --------------
    k2_launches, shipped = phase_rawwav_shipped(
        dev, rng, bundle, codes, signature, model_gpu, model_cpu,
        data_mean, data_std)
    phase_wall("phase 7")

    # -- phase 8: the same at precision="default" (bfloat16 K2) -----------
    k2_launches += phase_rawwav_default(dev, shipped, model_gpu, data_mean,
                                        data_std)
    phase_wall("phase 8")

    # -- phase 9: raw-wav serving, wavvq preset -----------------------------
    k1_launches += phase_rawwav_wavvq(dev, rng, serving, db, cfg)
    phase_wall("phase 9")

    # -- phase 10: generate CLI ----------------------------------------------
    phase_generate(rng, bundle, codes, signature, shipped["feats_db"],
                   shipped["enc_cpu"], model_cpu)
    phase_wall("phase 10")

    # -- phase 11: batched serving ------------------------------------------
    k1, k2, staged = phase_batch(dev, rng, serving, db, cfg, shipped,
                                 model_gpu, data_mean, data_std)
    k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
    phase_wall("phase 11")

    # -- phase 12: streaming pools and sessions -----------------------------
    k1, k2 = phase_streaming(dev, serving, staged)
    k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
    phase_wall("phase 12")

    # -- phase 13: the shipped preset at precision="high" --------------------
    k2_launches += phase_high(dev, shipped, model_gpu, data_mean, data_std)
    phase_wall("phase 13")

    # -- phase 14: transcript -> MiniLM -> context ingress ------------------
    k2_launches += phase_transcript(dev, rng, shipped, staged["server"])
    del staged
    phase_wall("phase 14")

    # -- phase 15: database build on the card -> serve, and the CLIs -------
    k2_b8 = k2_times(dev, 8)
    with tempfile.TemporaryDirectory() as tmp:
        K1.launches = K2.launches = 0
        built = phase_build(dev, rng, shipped, model_cpu, tmp)
        phase_build_clis(dev, built, shipped["enc_cpu"], tmp)
        k1, k2 = K1.launches, K2.launches
    log(f"phase 15 K2 at B=8 (extract_wavlm's batch), f32: kernel_ms="
        f"{k2_b8['ms']:.5f} library_ms={k2_b8['library_ms']:.5f} (SDPA) "
        f"bound_ms={k2_b8['bound_ms']:.5f} ({k2_b8['bound_by']}); phase 15 "
        f"launches: K1 {k1}, K2 {k2}")
    if not (k1 and k2):
        raise SystemExit("phase 15 did not launch both kernels")
    k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
    del shipped, built
    phase_wall("phase 15")

    # -- the kernels line and the result ------------------------------------
    kernels_line = {"kernels": [{
        "name": "levenshtein_matrix",
        "route": "cuda",
        "source": "qpgesture_tpu_torch/csrc/levenshtein.cu",
        "replaces": "qpgesture_tpu/ops/pallas_kernels.py:60",
        "launches": k1_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "gated_flash_attention",
        "route": "cuda",
        "source": "qpgesture_tpu_torch/csrc/flash_attention.cu",
        "replaces": "qpgesture_tpu/ops/flash_attention.py:106",
        "launches": k2_launches,
        **k2_line,
    }]}
    log(f"total {time.time() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
