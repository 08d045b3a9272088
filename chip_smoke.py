#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds every CUDA kernel of the port from the sources in the checkout (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version on the card, and drives the port's paths, each with the kernel
counts set to 0 just before it and read just after. Every phase from 4 on
but 6 scans on the card, so each must launch K3, the fusion scan kernel
(phase 4: once a request):

  phases 3-5   K1 checks and times; host-staged wavvq serving (J=1024
               database, 3 requests of 6 windows = 24 s clips) and the
               match -> decode CLI (a J=64 database on disk);
  phase 6      K2 in float32 and bfloat16 against its plain version at
               its tile edges, hd 16/32/64; K2 / plain / SDPA times in
               both types (and K2 / SDPA at serve_batch's B=24);
  phase 6b     K4 (w2v-BERT 2.0's relative-key attention) against its
               plain version, hd 16/64, T up to 300; K4 / plain / SDPA
               times at the pool's (16, 16, 199, 64) beside the
               benchmark's relkey_roofline bound; raw-wav serving of the
               shipped preset with w2v-BERT 2.0 at its published widths
               (K4 once a layer), codes against host staging, features
               against the benchmark's plain reference;
  phase 6c     K5 (vq-wav2vec's one-group GroupNorm + activation) against
               its plain version at the 8 layers' frames of a clip (6
               windows) and a batch (96), C = 32 with ragged T, GELU and
               ReLU; K5 / plain / split-row var_mean + affine + GELU times
               over the 8 layers beside the bound of 8 B an element at
               3.35 TB/s;
               only the launches of the wavvq phases' main-path work (9,
               15, 17, 18, 21), each of which must launch K5, are counted
               in the kernels line;
  phase 6d     K6 (WavLM's positional conv + bias + GELU + residual,
               channels last) against its plain version (cuDNN's grouped
               conv1d, trim, GELU, add) at B = 1 / 6 / 16 and T = 1 / 64 /
               199 / 257, 1024 channels in groups of 64, and 768 in groups
               of 48; K6 / plain / cuDNN's conv alone / the unfolded
               torch.bmm route times at a clip's 6 and a tick's 16 windows
               of 199 frames beside the FMA bound, cuDNN's conv and the
               plain version again under cudnn_autotune, and K6 at each
               frame tile; only the launches of the phases that run WavLM at
               "highest" on the card (7, 10, 11, 12, 14, 15, 16, 22; each
               must launch K6) are counted in the kernels line;
  phase 6e     K2's bias-free float32 instantiation (Whisper's plain
               attention) against its plain version at its tile edges, hd
               16/32/64, and at Whisper's (1, 20, 1500, 64) handed over as
               (B, T, H, hd) views; kernel / plain / SDPA f32 times there
               beside the bound of the benchmark's whisper_attn_roofline;
               raw-wav serving of the shipped preset with Whisper-large-v3's
               encoder at its published widths (each 24 s clip one 30 s
               utterance, the bias-free K2 once a layer), codes against host
               staging, features against the benchmark's plain reference;
  phase 6f     K7 (the per-code candidate reduction) against its plain
               version, bit for bit: ties, negative distances and both
               zeros, codes that never occur, ragged N, and every cell's
               shapes, k = 512 codes: the vq-wav2vec clip's and batch's Q
               = 48 and 768 queries against N = 425 984 positions in
               float32 and int32, the J = 1024 clip's and tick's Q = 48 and
               128 against N = 26 624 in float32; K7 / plain times there
               beside the bound of reading the matrix and the codes once
               at 3.35 TB/s; every later phase that builds tables on the
               card must launch K7 (phase 4: two calls a request, and the
               tables span's segmin_kernel counter reads 2), and only
               those launches, timing and check loops left out
               (``uncounted``), reach the kernels line;
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
               against the library calls;
  phase 16     the matching surface and generate extras: phase 7's
               requests served at cosine_precision "high" (shipped_fast,
               bf16x3) and "default" and under bfloat16 / float16 residency
               of phase 7's database (codes against "highest", distances
               against float64, resident bytes), a shipped_fast
               predict_batch; reference-ties matching on phase 4's database
               (K1) against the CPU port and the reference-ties oracle;
               verify-release --device cuda on a tree in the published
               layout; generate --resync, resync-apply and generate --model
               end2end with a full-width ResyncNet and GeneratorGRU against
               the CPU port;
  phase 16b    the fusion scan kernel (K3) against its plain loop (bit for
               bit, device ms beside its dependent-load bound and the
               loop's ms) on a request of each preset and on 16 lanes,
               pairs sliced from the resident phase / amp; the engines'
               resident bytes;
  phase 17     training: train-vqvae at the shipped width (batch 256, 3
               epochs with validation, --resume for a 4th), decode and
               signature from its output directory, train-pae and
               train-end2end (GRU targets: the trained VQ-VAE's codes) and
               generate --model end2end from their directories; one step
               of each trainer card against CPU, a VQ-VAE step under sync
               debug mode "error", each step's time, windows/s, idle share
               and peak memory; phase 15's train split rebuilt with the
               trained VQ-VAE's codes and the trained PAE's phases, served
               (wavvq, K1) against the CPU port;
  phase 18     resync training and evaluation: raw-pose GestureKNN over a
               K=1024 database (search_motion_batch of 8 lanes against
               solo calls and the CPU port, warmup --rawpose-batch);
               ResyncNet's training pairs from phase 15's train split by
               fake_training_pairs; train-resync at full width (ResyncNet
               and the critic, batch 100), one iteration card against CPU,
               one under sync debug "error", D-only and D + G iteration
               times against the counted operations; generate --preset
               wavvq --resync and resync-apply from the train-resync
               directory (K1) against the CPU port; train-fgd and evaluate
               (the trained extractor and phase 17's VQ-VAE) card against
               CPU; the batched MFCC on phase 15's recordings;
  phase 19     the rest of the single-GPU surface: a VQ-VAE training step
               at the shipped width and batch 256 at conv_precision
               "highest", "default" (bfloat16 operands) and "high"
               (bf16x3), times and shares of the peak, one step of each
               low precision card against CPU; phase 15's windows encoded
               at each precision (agreement with "highest"), a wavvq
               request served through K1 from the "default" codes against
               the CPU port, levels=2 encode / decode, a flax-layout
               .msgpack VQ-VAE through decode --checkpoint; SimpleVQVAE and
               Seq2SeqNet at full width, card against CPU, step times;
               build-db --dataset trinity in both modes on a synthetic
               GENEA-layout split and the store's windows gathered on the
               card; render/analytics on the "default" codes.
  phase 20     process groups on the one card: a J=4096 database (wavvq
               and shipped) served sharded by world 1 under NCCL and by 2
               and 4 gloo ranks sharing the card (predict_sharded with K1
               and the cosine tables, predict_batch_sharded, serve_sharded
               with WavLM-Large's K2, tick_sharded interleaved with tick),
               every rank against the single device bit for bit, with
               per-rank tables and combine times and resident bytes (the
               engine's construction and the rank's shard); one
               data-parallel step of each trainer in 2 ranks against one
               device; match --sharded always / auto and train-vqvae under
               torch.distributed.run;
  phase 21     the port's bench (qpgesture_tpu_torch/bench.py, the JAX
               package's bench.py sections) in this process: wavvq (K1) and
               wavlm serving with their device breakdowns, 16 batched
               clips, raw-wav wavvq and WavLM-Large at "default" (bfloat16
               K2), the VQ-VAE step at both precisions, raw-pose search,
               PAE extraction; every section present, wavvq codes against
               the CPU port.
  phase 22     the port's examples (qpgesture_tpu_torch/examples/):
               parity_soak over 9 presets x 5 fixtures and
               chip_parity_sweep (gesture KNN, the 3600-frame long clip
               against the CPU port) with 0 mismatches against the oracle,
               then the sweep at the low cosine precisions and residencies
               (differing codes reported); tie_divergence_sweep (40
               fixtures, K1) against the CPU port; scale_study for wavvq
               at J = 1024 / 4096 / 16384 and wavlm at 1024 (bytes
               against the shapes, wavvq codes against the CPU port at
               1024 and 16384); streaming_soak (60 pushes, 20 ticks of 16
               streams, both presets); serve_production (bucketed == solo,
               codes against the CPU port); train_campaign in subprocesses
               (4 epochs killed after 2 with exit 42, resumed, post-eval);
               demo_synthetic to a BVH; rawwav_latency at "highest" (K2
               float32) and "default" (K2 bfloat16) with its agreement.

It prints one line per check. The last four lines are the bench's compact
JSON line, the card's name and power limit, one JSON object with every
kernel's launches, error and times (K3's from phase 16b's first case), and ``{"ok": true, "device":
{...}}``. Any failure exits nonzero
before that last line; so does a machine without a CUDA device, and a
directory that holds this script without the package.

Imports nothing of JAX: the card's machine runs the port alone.
"""
from __future__ import annotations

import contextlib
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
# K4 against its plain version: float32 on both sides, summation order only
# (an online softmax over 32-key tiles against the (T, T) logits)
K4_ATOL = 1e-5
# K5 against its plain version: another summation order of the moments in
# float32 (tests/test_torch_cuda.py states the same tolerance)
K5_ATOL = K5_RTOL = 1e-5
# K6 against its plain version: each output sums 8192 float32 products in
# another order than cuDNN's (tests/test_torch_cuda.py states the same
# tolerance and why)
K6_ATOL = 5e-5
# vq-wav2vec's 8 layers' frames of a 64000-sample window (the benchmark's
# configuration: (512,10,5), (512,8,4), (512,4,2) x 3, (512,1,1) x 3)
K5_FRAMES = (12799, 3198, 1598, 798, 398, 398, 398, 398)
# w2v-BERT 2.0 features against the benchmark's plain reference (relative
# Frobenius error of a window): float32 on both sides, other summation
# orders through 24 layers; the cell's enc_rel_err limit
W2V_FEAT_RTOL = 1e-4
# Whisper-large-v3's encoder features against the benchmark's plain
# reference, as w2v-BERT's: float32 on both sides, other summation orders
# through 32 layers; the cell's enc_rel_err limit
WHISPER_FEAT_RTOL = 1e-4
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
# phase 6f: K7 at each cell's (label, queries Q, positions N, distance
# types): the vq-wav2vec cells' audio side reads K1's int32 matrix and their
# text side float32; the J = 1024 cells' sides are both cosine
K7_SHAPES = (("vq batch", 768, 425984, ("float32", "int32")),
             ("vq clip", 48, 425984, ("float32", "int32")),
             ("j1024 clip", 48, 26624, ("float32",)),
             ("j1024 tick", 128, 26624, ("float32",)))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # float32 outside the tensor cores (TF32 off)
BF16_TC_FLOPS = 989e12      # bfloat16 tensor cores, dense
# 32-bit ALU operations an SM issues per clock: 4 schedulers x 32 lanes,
# the rate behind the data sheet's 67 TFLOP/s float32 (an FMA counted as
# two). K1 runs above the 64/clock of the integer-only units on the
# whole-corpus shape, so this is the peak its operations are held to.
ALU_OPS_PER_SM_CLOCK = 128
# phase 17, training: synthetic clips of 60 s at 60 fps, windowed at stride
# 32 (106 windows a clip: 16 steps of 256 per epoch from 40 clips)
TRAIN_CLIPS, VAL_CLIPS, TRAIN_CLIP_FRAMES = 40, 8, 3600
TRAIN_BATCH = 256           # TrainConfig.batch_size
PAE_EPOCHS = 3
E2E_WINDOWS, E2E_EPOCHS = 256, 5
TRAIN_TIMED_STEPS = 10
# the models' configurations: the defaults (VQVAEConfig, PAEConfig,
# End2EndConfig) are the repo's shipped widths
TRAIN_SECTIONS = {"VQVAE": {}, "PAE": {}, "end2end": {}}
# one training step, card against CPU from the same state and batch: float32
# on both sides (TF32 off), other summation orders (cuDNN's autotuning picks
# them anew in every run). Loss relative, and the EMA codebook statistics
# and BatchNorm running statistics relative to each tensor's largest
# magnitude: these hold the forward pass tightly. Gradients per tensor as
# ||g_card - g_cpu|| / ||g_cpu||, 1e-2: an L1 loss term takes the other
# sign where output and target agree to rounding (each such element moves
# dL/dx by 2/N), and the PAE's phase heads end in atan2(v1, v0), whose
# gradient grows as 1/|v|^2 near the origin; on an H100 both reached 1e-3
# to 2e-3 in some runs, an error in the step gives O(1). The PAE's
# BatchNorms average 240-tap conv outputs (32 400 products each): 1e-4.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-2
TRAIN_STATS_RTOL = 1e-5
PAE_STATS_RTOL = 1e-4
# phase 18: the raw-pose database (K sequences x 240 frames, tests/
# fixtures.py's shapes) and its lanes, RAWPOSE_CPU_LANES of them held
# against the CPU port; ResyncNet's training pairs (RESYNC_REPEATS
# stochastic-k draws per phase 15 train window), ResyncConfig's batch, the
# CLI's iterations, the batch of the card-vs-CPU check, the timed
# iterations (a multiple of 4); the FGD extractor's epochs
RAWPOSE_K, RAWPOSE_C, RAWPOSE_CPU_LANES = J, 8, 2
RESYNC_REPEATS, RESYNC_BATCH, RESYNC_ITERS = 4, 100, 50
RESYNC_CHECK_BATCH, RESYNC_TIMED = 4, 8
FGD_EPOCHS = 3
# one resync iteration card vs CPU, the critic's loss in two parts: its
# scores (mean D(fake) - mean D(real)) at TRAIN_LOSS_RTOL, and the penalty
# term relative to itself; d_loss at the parts' sum. The penalty's double
# backward carries the LeakyReLU slopes of inputs within rounding of 0, so
# either float32 side can move it: over two runs of a probe that repeated
# this check in fresh processes (96 checks of 24 trainings each) on an H100
# it differed card vs CPU by up to
# 2.1e-3 of itself (27 of 96 checks over 1e-5 of the loss, in every cuDNN
# mode alike), the CPU's float32 from float64 by up to 8.6e-5 of the loss,
# the scores by at most 3.7e-7. Faults planted on the card side read 0.93
# to 1.0 of the penalty (its points at eps 0.5, its norm over one axis),
# ~200x the d_loss tolerance (lambda dropped), and scores 5e-6 to 1.2e-4
# with the penalty 1.2e-3 to 9e-3 of itself (TF32 convs): at 5e-3 every
# sound check passes and every planted one fails
RESYNC_PENALTY_RTOL = 5e-3
# one resync iteration card vs CPU, gradients per tensor: a LeakyReLU
# input within rounding of 0 takes the other slope on one side, and the
# penalty differentiates the slopes again; at batch 4 a single such element
# moves a whole layer's gradient by ~1e-3 of its norm. On an H100 the two
# differed by up to 8.8e-3 (the check also logs each side against a float64
# CPU reference); an error in the step gives O(1)
RESYNC_GRAD_RTOL = 3e-2
# evaluate's feature-space FGDs card vs CPU: embeddings and codes from
# float32 encoders in other summation orders, relative (beyond the JSON's
# rounding to 4 decimals)
FGD_RTOL = 1e-3
# phase 19: the VQ-VAE and SimpleVQVAE steps' batch (TrainConfig's), the
# batch of their card-vs-CPU checks, the synthetic clips the step's batch is
# drawn from; Seq2SeqNet at the seq2seq configuration of Yoon et al.'s
# trimodal gesture code (config/seq2seq.yml: hidden 200, 2 layers, word
# embedding 300, 34 poses of 27 with 4 teacher-forced, dropout 0.1, batch
# 128; a 30 000-word vocabulary, sentences of up to 16 words); its eval
# outputs card vs CPU (cuDNN's GRU against the CPU's over 33 autoregressive
# steps of O(1) poses); the Trinity split (GENEA 2020 has 23 training
# recordings of ~10 minutes: cut to 2, and 1 for validation)
P19_BATCH, P19_CHECK_BATCH, P19_CLIPS = 256, 8, 8
SEQ2SEQ = dict(vocab=30000, embed=300, hidden=200, pose=27, frames=34, pre=4,
               layers=2, dropout=0.1)
SEQ2SEQ_BATCH, SEQ2SEQ_WORDS = 128, 16
SEQ2SEQ_ATOL = 1e-4
# "default" (bfloat16 operands) card against CPU: the same rounding, but a
# float32 activation that differs in its last bit between the two (other
# summation orders) can round its bfloat16 operand the other way (2^-8 of
# it), and 20+ layers carry such flips into the latents, the codes' distance
# gaps (relative, as check_code_flips measures them) and the gradients (on
# an H100 one step's differed by 1.5e-2 per tensor norm at batch 8; "high"'s
# split has no such flip and is held as "highest" is). An error in the path
# gives O(1)
DEFAULT_CODE_GAP_RTOL = 1e-2
DEFAULT_LOSS_RTOL = 5e-3
DEFAULT_GRAD_RTOL = 0.1
DEFAULT_POSE_RTOL = 2e-2
TRINITY_TRAIN, TRINITY_VAL, TRINITY_MINUTES = 2, 1, 10.0
# the batched MFCC: cuFFT against pocketfft, float32 products; log-mel
# values reach ~15. The host oracle is float64 (the JAX package's test of
# its device MFCC holds 2e-3)
MFCC_ATOL = 2e-3
MFCC_ORACLE_ATOL = 2e-3
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


@contextlib.contextmanager
def uncounted():
    """A timing or check loop: K7's launches inside the block are taken off
    its counter again, so that only the main path's reach the kernels
    line."""
    from qpgesture_tpu_torch.ops import segmin_cuda as K7
    before = K7.launches
    try:
        yield
    finally:
        K7.launches = before


def log_profile(phase: str, fn) -> dict:
    """Profile one call of fn: device busy time, idle share, top kernels.
    Returns {kernel name: (total device us, count)}."""
    from qpgesture_tpu_torch.utils.profiling import device_busy
    busy_s, wall_s, kernels = device_busy(fn)
    log(f"{phase} profile: device busy {busy_s * 1e3:.3f} ms of "
        f"{wall_s * 1e3:.3f} ms wall (idle share "
        f"{1 - busy_s / wall_s:.3f}); top kernels:")
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


def make_data(rng, J=J):
    """Seeded synthetic speaker database of J sequences and test clips at
    the shapes of tests/fixtures.py (only the arrays the wavvq preset
    reads)."""
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


def phase_k4(dev, rng, bundle, codes, signature, vqvae_gpu, data_mean,
             data_std) -> dict:
    """K4 (relative-key attention) against its plain version at a partial
    tile, w2v-BERT's window at the pool's batch and a longer window; K4,
    its plain version and SDPA (the relative-key term materialised as its
    float32 attn_mask) at (16, 16, 199, 64), beside the bound of the
    benchmark's relkey_roofline (benchmark/models/w2v_bert.py relkey_work
    at the TF32 and HBM rates); then raw-wav serving with w2v-BERT 2.0 at
    its published widths (24 layers, random weights): K4 once a layer, the
    codes of host staging, the features against the benchmark's plain
    reference. Returns the kernels-line fields and K4's launches."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from benchmark import spec, yardstick
    from benchmark.reference import w2v_bert as ref_w2v_bert
    from qpgesture_tpu_torch.core.config import MATCH_PRESETS
    from qpgesture_tpu_torch.match import engine as eng
    from qpgesture_tpu_torch.match.database import (stage_database,
                                                    stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.models.w2v_bert import W2VBert
    from qpgesture_tpu_torch.ops import relkey_attention_cuda as K4
    from qpgesture_tpu_torch.serve import RawWavServer

    gen = torch.Generator(device=dev).manual_seed(SEED)
    left, right = 64, 8

    def inputs(B, H, T, hd):
        q, k, v = torch.randn(3, B, T, H, hd, generator=gen,
                              device=dev).transpose(2, 3)
        return q, k, v, torch.randn(left + right + 1, hd, generator=gen,
                                    device=dev)

    max_err = 0.0
    for B, H, T, hd in ((1, 4, 37, 64), (16, 16, 199, 64), (2, 16, 300, 64),
                        (2, 3, 130, 16)):
        q, k, v, e = inputs(B, H, T, hd)
        got = K4.relkey_attention(q, k, v, e, left=left, right=right,
                                  sm_scale=hd ** -0.5)
        torch.cuda.synchronize()
        err = float((got - K4.relkey_attention_plain(
            q, k, v, e, left=left, right=right, sm_scale=hd ** -0.5)
        ).abs().max())
        max_err = max(max_err, err)
        log(f"phase 6b K4 B={B} H={H} T={T} hd={hd}: max_abs_err {err:.3e} "
            f"(tol {K4_ATOL})")
        if err > K4_ATOL:
            raise SystemExit(f"K4 disagrees with its plain version at "
                             f"{(B, H, T, hd)}: {err}")

    B, H, T, hd = 16, 16, 199, 64
    q, k, v, e = inputs(B, H, T, hd)
    scale = hd ** -0.5
    mask = torch.gather(torch.matmul(q * scale, e.t()), 3, K4.distances(
        T, left, right, dev).expand(B, H, T, T))
    calls = {
        "kernel": lambda: K4.relkey_attention(
            q, k, v, e, left=left, right=right, sm_scale=scale),
        "plain": lambda: K4.relkey_attention_plain(
            q, k, v, e, left=left, right=right, sm_scale=scale),
        "library": lambda: F.scaled_dot_product_attention(
            q * scale, k, v, attn_mask=mask, scale=1.0),
    }
    sdpa_err = float((calls["library"]() - calls["plain"]()).abs().max())
    ms = {name: device_ms(fn, 20) for name, fn in calls.items()}
    call_ms = median_ms(calls["kernel"], 20)
    w2v = spec.plugin("models", "w2v_bert")
    ops, nbytes = w2v.relkey_work(B, H, T, hd, left + right + 1)
    p = yardstick.H100_SXM
    bound_ms = 1e3 * yardstick.least_seconds(ops, nbytes, p["tf32_flops"],
                                             p["hbm_bytes"])
    bound_by = "operations" if ops / p["tf32_flops"] >= \
        nbytes / p["hbm_bytes"] else "bytes"
    f32_ms = 1e3 * ops / F32_FLOPS
    log(f"phase 6b K4 times at B={B} H={H} T={T} hd={hd}: kernel_ms="
        f"{ms['kernel']:.5f} plain_ms={ms['plain']:.5f} library_ms="
        f"{ms['library']:.5f} (SDPA with the term as attn_mask, max_abs_err "
        f"vs plain {sdpa_err:.3e}) bound_ms={bound_ms:.5f} ({bound_by}, "
        f"relkey_roofline's; at the float32 FMA peak {f32_ms:.5f}); one "
        f"kernel call between two events {call_ms:.5f}")
    del q, k, v, e, mask

    # raw-wav serving with the published w2v-BERT
    t0 = time.time()
    torch.manual_seed(SEED)
    encoder = W2VBert(device=dev)
    feats_db = np.random.default_rng(SEED + 1).standard_normal(
        (J, 199, encoder.cfg.hidden_size), dtype=np.float32)
    cfg = MATCH_PRESETS["shipped"]
    db = stage_database(cfg, bundle, codes, signature, wavlm=feats_db)
    engine = eng.CodeKNNEngine(cfg, db, device=dev)
    server = RawWavServer(engine, vqvae_gpu, encoder, data_mean, data_std)
    wavs = [(rng.randn(W, 64000) * 3000).astype(np.int16)
            for _ in range(N_REQUESTS + 1)]
    ctxs = [rng.randn(W, 30, 1, 384).astype(np.float32)
            for _ in range(N_REQUESTS + 1)]
    log(f"phase 6b set-up: w2v-BERT 2.0, "
        f"{sum(p.numel() for p in encoder.parameters())} parameters; "
        f"{time.time() - t0:.1f} s")

    def serve(r):
        return server.serve(wavs[r], ctxs[r], init_code=0,
                            rng=np.random.RandomState(cfg.seed))

    serve(N_REQUESTS)                   # warm-up request
    torch.cuda.synchronize()
    req_ms = []
    for r in range(N_REQUESTS):
        before = K4.launches
        t0 = time.perf_counter()
        got_codes, poses = serve(r)
        req_ms.append(1e3 * (time.perf_counter() - t0))
        if K4.launches - before != encoder.cfg.num_hidden_layers:
            raise SystemExit(f"request {r} launched K4 "
                             f"{K4.launches - before} times, not once a "
                             f"layer")
        enc = encoder(torch.as_tensor(wavs[r], device=dev).float() / 32768.0)
        want = engine.predict(
            stage_test_audio(cfg, db, wavlm=enc.cpu().numpy()),
            stage_test_context(db, ctxs[r]), init_code=0,
            init_phase=np.zeros((8, 16), np.float32),
            rng=np.random.RandomState(cfg.seed)).codes
        if not np.array_equal(got_codes, want) or \
                poses.shape != (W * 240, 135):
            raise SystemExit(f"request {r}: w2v-BERT serving differs from "
                             f"host staging")
    wav = torch.as_tensor(wavs[0][:2], device=dev).float() / 32768.0
    out = encoder(wav)
    with open(os.path.join(REPO, "benchmark", "configs",
                           "w2v-bert-2.0-j1024.json")) as f:
        ref_cfg = {**json.load(f), **dataclasses.asdict(encoder.cfg)}
    want = ref_w2v_bert.features(dict(encoder.state_dict()), ref_cfg, wav)
    rel = float(((out - want).flatten(1).norm(dim=1)
                 / want.flatten(1).norm(dim=1)).max())
    log(f"phase 6b w2v-BERT serve p50 {statistics.median(req_ms):.3f} ms "
        f"over {N_REQUESTS} requests of {W} windows; codes == host staging; "
        f"features against the plain reference: "
        f"relative error {rel:.3e} (tol {W2V_FEAT_RTOL})")
    if rel > W2V_FEAT_RTOL:
        raise SystemExit(f"w2v-BERT features differ from the reference by "
                         f"{rel}")
    return dict(max_abs_err=max_err, ms=ms["kernel"], plain_ms=ms["plain"],
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=ms["library"])


def phase_k5(dev) -> dict:
    """K5 (one-group GroupNorm, affine and activation) against its plain
    version at vq-wav2vec's 8 layers of a clip (B = 6) and a batch
    (B = 96), C = 512, and at C = 32 / 3 with ragged T for both
    activations; then K5, its plain version (F.group_norm + F.gelu, what
    nn.GroupNorm + nn.GELU run) and the simplest library design that also
    splits a window's moments across blocks (``library``, timed only as a
    yardstick) over the 8 layers of each, beside the bound of reading and
    writing each element once (8 B at 3.35 TB/s). Returns the kernels-line
    fields (the clip's at the top level, the batch's under "batch")."""
    import torch
    import torch.nn.functional as F
    from qpgesture_tpu_torch.ops import groupnorm_cuda as K5

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(B, C, T):
        x = torch.randn(B, C, T, generator=gen, device=dev) * 3.0 + 0.5
        return (x, 1.0 + 0.1 * torch.randn(C, generator=gen, device=dev),
                0.1 * torch.randn(C, generator=gen, device=dev))

    max_err = 0.0
    cases = ([(B, 512, T, "gelu") for B in (6, 96) for T in K5_FRAMES[:5]]
             + [(3, 32, T, act) for T in (1, 7, 399, 1001)
                for act in ("gelu", "relu")] + [(2, 3, 7, "gelu")])
    for B, C, T, act in cases:
        x, w, b = inputs(B, C, T)
        got = K5.groupnorm1_act(x, w, b, 1e-5, act)
        torch.cuda.synchronize()
        want = K5.groupnorm1_act_plain(x, w, b, 1e-5, act)
        excess = float(((got - want).abs() - K5_RTOL * want.abs()).max())
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        log(f"phase 6c K5 B={B} C={C} T={T} {act}: max_abs_err {err:.3e} "
            f"(tol {K5_ATOL} + {K5_RTOL} |plain|)")
        if excess > K5_ATOL:
            raise SystemExit(f"K5 disagrees with its plain version at "
                             f"{(B, C, T, act)}: {err}")
        if not torch.equal(got, K5.groupnorm1_act(x, w, b, 1e-5, act)):
            raise SystemExit(f"K5 gave other bits the second time at "
                             f"{(B, C, T, act)}")
        del x, got, want

    def library(x, w, b):
        """torch.var_mean over each flattened window (PyTorch's reduction
        splits a long row across blocks), the affine folded into one
        addcmul, then GELU: three launches."""
        B = x.shape[0]
        var, mean = torch.var_mean(x.view(B, -1), dim=1, correction=0)
        scale = torch.rsqrt(var + 1e-5)[:, None] * w            # (B, C)
        shift = b - mean[:, None] * scale
        return F.gelu(torch.addcmul(shift[..., None], x, scale[..., None]))

    out = {}
    for label, B in (("clip", 6), ("batch", 96)):
        layers = [inputs(B, 512, T) for T in K5_FRAMES]
        lib_err = max(float((library(x, w, b) - K5.groupnorm1_act_plain(
            x, w, b, 1e-5, "gelu")).abs().max()) for x, w, b in layers)
        calls = {
            "kernel": lambda: [K5.groupnorm1_act(x, w, b, 1e-5, "gelu")
                               for x, w, b in layers],
            "plain": lambda: [K5.groupnorm1_act_plain(x, w, b, 1e-5, "gelu")
                              for x, w, b in layers],
            "library": lambda: [library(x, w, b) for x, w, b in layers],
        }
        with torch.no_grad():
            ms = {name: device_ms(fn, 5) for name, fn in calls.items()}
            per_layer = [device_ms(lambda: K5.groupnorm1_act(
                x, w, b, 1e-5, "gelu"), 10) for x, w, b in layers]
        elems = B * 512 * sum(K5_FRAMES)
        bound_ms = 1e3 * 8.0 * elems / HBM_BYTES_PER_S
        log(f"phase 6c K5 times at B={B}, the 8 layers: kernel_ms="
            f"{ms['kernel']:.5f} plain_ms={ms['plain']:.5f} library_ms="
            f"{ms['library']:.5f} (var_mean + addcmul + GELU, max_abs_err "
            f"{lib_err:.3e} against plain) bound_ms="
            f"{bound_ms:.5f} (bytes: 8 B x {elems} elements); per layer "
            f"{[round(t, 5) for t in per_layer]} ms")
        out[label] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                          bound_ms=bound_ms, bound_by="bytes",
                          library_ms=ms["library"],
                          per_layer_ms=per_layer)
        del layers, calls
        torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, **out["clip"], batch=out["batch"])


def phase_k7(dev) -> dict:
    """K7 (the per-code candidate reduction) against its plain version,
    bit for bit (mins as int32 bits, args, matched) on small adversarial
    cases and at every cell's shapes (K7_SHAPES), k = 512 codes; then the
    device ms of one call of each (CUDA events around calls queued behind
    a spin), beside the plain version's (scatter_reduce, gather, where,
    scatter_reduce: the only PyTorch route, so it is also the library
    yardstick) and the bound of reading the (Q, N) matrix and the N int64
    codes once at 3.35 TB/s. Returns the kernels-line fields (the vq
    batch's float32 at the top level, the rest under "times")."""
    import torch
    from qpgesture_tpu_torch.ops import segmin_cuda as K7

    gen = torch.Generator(device=dev).manual_seed(SEED)
    k, unmatched = 512, 1000.0

    def check(name, dist, seg, kk):
        got = K7.segment_min_argmin(dist, seg, kk, unmatched)
        torch.cuda.synchronize()
        want = K7.segment_min_argmin_plain(dist.cpu(), seg.cpu(), kk,
                                           unmatched)
        same = (torch.equal(got[2].cpu(), want[2])
                and torch.equal(got[1].cpu(), want[1])
                and torch.equal(got[0].cpu().view(torch.int32),
                                want[0].view(torch.int32)))
        again = K7.segment_min_argmin(dist, seg, kk, unmatched)
        twice = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"phase 6f K7 {name}: Q={dist.shape[0]} N={dist.shape[1]} "
            f"k={kk} {str(dist.dtype)[6:]} bit-equal={same} "
            f"same bits twice={twice}")
        if not (same and twice):
            raise SystemExit(f"K7 disagrees with its plain version: {name}")

    def dist_of(Q, n, dtype):
        if dtype == torch.int32:
            return torch.randint(0, 23, (Q, n), generator=gen, device=dev,
                                 dtype=torch.int32)
        return 1.0 - torch.rand(Q, n, generator=gen, device=dev) * 1.0001

    small = torch.tensor([-0.0, 0.0, -1e-7, 1e-7, 0.5, 2.0], device=dev)
    ties = small[torch.randint(0, 6, (6, 3 * 2048 + 13), generator=gen,
                               device=dev)]
    check("ties, negatives and both zeros, ragged N", ties,
          torch.randint(0, 16, (ties.shape[1],), generator=gen, device=dev),
          16)
    seg_gaps = torch.randint(0, 256, (4099,), generator=gen, device=dev) * 2
    check("odd codes never occur", dist_of(5, 4099, torch.float32),
          seg_gaps, 512)
    times = {}
    for label, Q, N, dtypes in K7_SHAPES:
        seg = torch.randint(0, k, (N,), generator=gen, device=dev)
        for dtype in (getattr(torch, t) for t in dtypes):
            dist = dist_of(Q, N, dtype)
            name = f"{label} {str(dtype)[6:]}"
            check(name, dist, seg, k)
            with torch.no_grad():
                ms = device_ms(lambda: K7.segment_min_argmin(
                    dist, seg, k, unmatched), 20)
                plain_ms = device_ms(lambda: K7.segment_min_argmin_plain(
                    dist, seg, k, unmatched), 2, reps=3, warmup=1)
            bound_ms = 1e3 * (4.0 * Q * N + 8.0 * N) / HBM_BYTES_PER_S
            splits, chunk = K7.plan(Q, N, *K7._resident(
                dist.device, k, int(dtype == torch.int32)))
            log(f"phase 6f K7 times {name}: Q={Q} N={N} kernel_ms={ms:.5f} "
                f"plain_ms={plain_ms:.5f} (also the library route) "
                f"bound_ms={bound_ms:.5f} (bytes: the (Q, N) matrix at 4 B "
                f"and N codes at 8 B) share={100 * bound_ms / ms:.1f} % "
                f"grid={splits} x {-(-Q // K7.ROWS)} chunk={chunk}")
            times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by="bytes", library_ms=plain_ms)
            del dist
            torch.cuda.empty_cache()
    return dict(**times["vq batch float32"], times=times)


def phase_k6(dev) -> dict:
    """K6 (WavLM's positional conv, bias, GELU and residual, channels last)
    against its plain version at B = 1 / 6 / 16 and T = 1 / 64 / 199 / 257
    with WavLM-Large's 16 groups of 64 channels and 128 taps, and at
    WavLM-Base's 768 channels in groups of 48; the same bits twice; then,
    at a clip's 6 and a tick's 16 windows of 199 frames, the device times of
    K6, its plain version (cuDNN's grouped conv1d on the transposed input,
    the trim, GELU and the add: what the module computed), cuDNN's grouped
    conv1d alone (``library``, which the port no longer calls) and the
    unfolded float32 torch.bmm route (a second yardstick: the windows
    copied out, one GEMM a group, bias, GELU, add), cuDNN's conv1d and the
    plain version again under ``device.cudnn_autotune`` (cuDNN times its
    algorithms for the shape and keeps the fastest), beside the bound of
    the FLOPs at the float32 FMA rate, and K6 at each frame tile the
    wrapper may pick. Returns the kernels-line fields (the clip's at the
    top level, the tick's under "tick")."""
    import torch
    import torch.nn.functional as F
    from qpgesture_tpu_torch.device import cudnn_autotune
    from qpgesture_tpu_torch.ops import posconv_cuda as K6

    gen = torch.Generator(device=dev).manual_seed(SEED)
    k = 128

    def inputs(B, T, C=1024, G=16):
        feats = torch.randn(B, T, C, generator=gen, device=dev)
        weight = torch.randn(C, C // G, k, generator=gen, device=dev) \
            * (4.0 / (k * C)) ** 0.5
        bias = 0.1 * torch.randn(C, generator=gen, device=dev)
        return feats, weight, K6.pack_weight(weight, G), bias, G

    max_err, failed = 0.0, []
    cases = [(B, T, 1024) for B in (1, 6, 16) for T in (1, 64, 199, 257)]
    with torch.no_grad():
        for B, T, C in cases + [(3, 199, 768)]:
            feats, weight, packed, bias, G = inputs(B, T, C)
            got = K6.posconv(feats, packed, bias)
            torch.cuda.synchronize()
            want = K6.posconv_plain(feats, weight, bias, G)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            log(f"phase 6d K6 B={B} T={T} C={C} (tile "
                f"{K6.frame_tile(B, T, G, C // G, k, K6.sm_count(dev))}): "
                f"max_abs_err {err:.3e} (tol {K6_ATOL})")
            if not err <= K6_ATOL:
                failed.append(f"K6 disagrees with its plain version at "
                              f"{(B, T, C)}: {err}")
            if not torch.equal(got, K6.posconv(feats, packed, bias)):
                failed.append(f"K6 gave other bits the second time at "
                              f"{(B, T, C)}")
            del feats, weight, packed, bias, got, want
    if failed:
        raise SystemExit("; ".join(failed))

    def library(feats, weight, bias, G):
        """cuDNN's grouped conv1d alone, on the transposed input."""
        return F.conv1d(feats.transpose(1, 2), weight, bias, padding=k // 2,
                        groups=G)

    def unfolded(feats, weight, bias, G):
        """Each frame's k x C/G window copied out (B T, G, C/G k), one
        float32 GEMM a group, then bias, GELU and the add."""
        B, T, C = feats.shape
        cg = C // G
        cols = F.pad(feats, (0, 0, k // 2, k // 2)).unfold(1, k, 1)[:, :T]
        cols = cols.reshape(B * T, G, cg * k).transpose(0, 1)
        w = weight.reshape(G, cg, cg * k).transpose(1, 2)
        y = torch.bmm(cols, w).transpose(0, 1).reshape(B, T, C)
        return feats + F.gelu(y + bias)

    out = {}
    with torch.no_grad():
        for label, B in (("clip", 6), ("tick", 16)):
            feats, weight, packed, bias, G = inputs(B, 199)
            bmm_err = float((unfolded(feats, weight, bias, G) - K6.
                             posconv_plain(feats, weight, bias, G)).abs().max())
            calls = {
                "kernel": lambda: K6.posconv(feats, packed, bias),
                "plain": lambda: K6.posconv_plain(feats, weight, bias, G),
                "library": lambda: library(feats, weight, bias, G),
                "bmm": lambda: unfolded(feats, weight, bias, G),
            }
            ms = {name: device_ms(fn, 10) for name, fn in calls.items()}
            want = calls["plain"]()
            with cudnn_autotune():
                tuned_err = float((calls["plain"]() - want).abs().max())
                ms.update({name + "_tuned": device_ms(calls[name], 10)
                           for name in ("library", "plain")})
            tiles = {tile: device_ms(lambda: K6.launch(feats, packed, bias,
                                                       tile), 10)
                     for tile in range(K6.MIN_TILE, K6.MAX_TILE + 1,
                                       K6.TILE_STEP)}
            tile = K6.frame_tile(B, 199, G, 64, k, K6.sm_count(dev))
            flops = 2.0 * B * 199 * 1024 * 64 * k
            bound_ms = 1e3 * flops / F32_FLOPS
            log(f"phase 6d K6 times at B={B}, T=199: kernel_ms="
                f"{ms['kernel']:.5f} (tile {tile}, "
                f"{flops / ms['kernel'] / 1e9:.1f} TFLOP/s) plain_ms="
                f"{ms['plain']:.5f} library_ms={ms['library']:.5f} (cuDNN's "
                f"grouped conv1d alone, "
                f"{flops / ms['library'] / 1e9:.1f} TFLOP/s) bmm_ms="
                f"{ms['bmm']:.5f} (unfolded torch.bmm route, max_abs_err "
                f"{bmm_err:.3e} against plain) library_tuned_ms="
                f"{ms['library_tuned']:.5f} plain_tuned_ms="
                f"{ms['plain_tuned']:.5f} (under cudnn_autotune, "
                f"{flops / ms['library_tuned'] / 1e9:.1f} TFLOP/s alone, "
                f"max_abs_err {tuned_err:.3e} against plain) "
                f"bound_ms={bound_ms:.5f} "
                f"(operations: {flops:.4g} FLOPs at {F32_FLOPS:.3g}); by "
                f"tile {json.dumps({t: round(v, 5) for t, v in tiles.items()})}")
            out[label] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                              bound_ms=bound_ms, bound_by="operations",
                              library_ms=ms["library"], bmm_ms=ms["bmm"],
                              library_tuned_ms=ms["library_tuned"],
                              plain_tuned_ms=ms["plain_tuned"],
                              tile=tile, tiles_ms=tiles)
            del feats, weight, packed, bias, calls, want
            torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, **out["clip"], tick=out["tick"])


def phase_nobias(dev, rng, bundle, codes, signature, vqvae_gpu, data_mean,
                 data_std):
    """K2's bias-free float32 instantiation against its plain version at
    the 128-query and 32-key tile edges and at Whisper's (1, 20, 1500, 64),
    q, k, v handed over as the (B, T, H, hd) projections' views, as
    Whisper's layers hand them; the kernel, its plain version and SDPA
    float32 (PyTorch's own choice of backend) there, beside the bound of
    the benchmark's whisper_attn_roofline (benchmark/models/whisper.py
    attn_work at the TF32 and HBM rates); then raw-wav serving with
    Whisper-large-v3's encoder at its published widths (random weights):
    the bias-free K2 once a layer, the codes of host staging, the features
    against the benchmark's plain reference. Returns the kernels-line
    fields and the bias-free launches of the serving requests."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from benchmark import spec, yardstick
    from benchmark.reference import whisper as ref_whisper
    from qpgesture_tpu_torch.core.config import MATCH_PRESETS
    from qpgesture_tpu_torch.match import engine as eng
    from qpgesture_tpu_torch.match.database import (stage_database,
                                                    stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.models.whisper import WhisperEncoder
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.serve import RawWavServer

    gen = torch.Generator(device=dev).manual_seed(SEED)
    tol = K2_ATOL["float32"]

    def inputs(B, H, T, hd):
        return torch.randn(3, B, T, H, hd, generator=gen,
                           device=dev).transpose(2, 3)

    max_err = 0.0
    shapes = [(2, 4, T, 64) for T in (1, 31, 32, 33, 127, 128, 129)] + \
        [(2, 4, 65, 16), (2, 4, 65, 32), (1, 20, 1500, 64)]
    for B, H, T, hd in shapes:
        q, k, v = inputs(B, H, T, hd)
        got = K2.gated_flash_attention(q, k, v, None, sm_scale=hd ** -0.5)
        torch.cuda.synchronize()
        err = float((got - K2.gated_attention_plain(
            q, k, v, None, sm_scale=hd ** -0.5)).abs().max())
        max_err = max(max_err, err)
        log(f"phase 6e K2 bias-free B={B} H={H} T={T} hd={hd}: "
            f"max_abs_err={err:.3e} (tol {tol})")
        if not err <= tol:
            raise SystemExit(f"K2 bias-free disagrees with its plain "
                             f"version at {(B, H, T, hd)}: {err}")

    B, H, T, hd = 1, 20, 1500, 64
    q, k, v = inputs(B, H, T, hd)
    scale = hd ** -0.5
    calls = {
        "kernel": lambda: K2.gated_flash_attention(q, k, v, None,
                                                   sm_scale=scale),
        "plain": lambda: K2.gated_attention_plain(q, k, v, None,
                                                  sm_scale=scale),
        "library": lambda: F.scaled_dot_product_attention(q, k, v,
                                                          scale=scale),
    }
    sdpa_err = float((calls["library"]() - calls["plain"]()).abs().max())
    ms = {name: device_ms(fn, 20) for name, fn in calls.items()}
    call_ms = median_ms(calls["kernel"], 20)
    ops, nbytes = spec.plugin("models", "whisper").attn_work(B, H, T, hd)
    p = yardstick.H100_SXM
    bound_ms = 1e3 * yardstick.least_seconds(ops, nbytes, p["tf32_flops"],
                                             p["hbm_bytes"])
    bound_by = "operations" if ops / p["tf32_flops"] >= \
        nbytes / p["hbm_bytes"] else "bytes"
    log(f"phase 6e K2 bias-free times at B={B} H={H} T={T} hd={hd} "
        f"float32: kernel_ms={ms['kernel']:.5f} plain_ms="
        f"{ms['plain']:.5f} library_ms={ms['library']:.5f} (SDPA float32, "
        f"max_abs_err vs plain {sdpa_err:.3e}) bound_ms={bound_ms:.5f} "
        f"({bound_by}, whisper_attn_roofline's; at the float32 FMA peak "
        f"{1e3 * ops / F32_FLOPS:.5f}); {ops / ms['kernel'] / 1e9:.1f} "
        f"TFLOP/s; one kernel call between two events {call_ms:.5f}")
    del q, k, v, calls

    # raw-wav serving with the published Whisper-large-v3 encoder
    t0 = time.time()
    torch.manual_seed(SEED)
    encoder = WhisperEncoder(device=dev)
    layers = encoder.cfg.encoder_layers
    feats_db = np.random.default_rng(SEED + 2).standard_normal(
        (J, 200, encoder.cfg.d_model), dtype=np.float32)
    cfg = MATCH_PRESETS["shipped"]
    db = stage_database(cfg, bundle, codes, signature, wavlm=feats_db)
    engine = eng.CodeKNNEngine(cfg, db, device=dev)
    server = RawWavServer(engine, vqvae_gpu, encoder, data_mean, data_std)
    wavs = [(rng.randn(W, 64000) * 3000).astype(np.int16)
            for _ in range(N_REQUESTS + 1)]
    ctxs = [rng.randn(W, 30, 1, 384).astype(np.float32)
            for _ in range(N_REQUESTS + 1)]
    log(f"phase 6e set-up: Whisper-large-v3's encoder, "
        f"{sum(p.numel() for p in encoder.parameters())} parameters; "
        f"{time.time() - t0:.1f} s")

    def serve(r):
        return server.serve(wavs[r], ctxs[r], init_code=0,
                            rng=np.random.RandomState(cfg.seed))

    serve(N_REQUESTS)                   # warm-up request
    torch.cuda.synchronize()
    K2.nobias_launches = 0
    req_ms = []
    for r in range(N_REQUESTS):
        before = K2.nobias_launches
        t0 = time.perf_counter()
        got_codes, poses = serve(r)
        req_ms.append(1e3 * (time.perf_counter() - t0))
        if K2.nobias_launches - before != layers:
            raise SystemExit(f"request {r} launched the bias-free K2 "
                             f"{K2.nobias_launches - before} times, not "
                             f"once a layer ({layers})")
        launches = K2.nobias_launches
        enc = encoder(torch.as_tensor(wavs[r], device=dev).float() / 32768.0,
                      clips=1)
        K2.nobias_launches = launches   # the check's own encode is not served
        want = engine.predict(
            stage_test_audio(cfg, db, wavlm=enc.cpu().numpy()),
            stage_test_context(db, ctxs[r]), init_code=0,
            init_phase=np.zeros((8, 16), np.float32),
            rng=np.random.RandomState(cfg.seed)).codes
        if not np.array_equal(got_codes, want) or \
                poses.shape != (W * 240, 135):
            raise SystemExit(f"request {r}: Whisper serving differs from "
                             f"host staging")
    served = K2.nobias_launches
    wav = torch.as_tensor(wavs[0], device=dev).float() / 32768.0
    out = encoder(wav, clips=1)
    with open(os.path.join(REPO, "benchmark", "configs",
                           "whisper-large-v3-j1024.json")) as f:
        ref_cfg = {**json.load(f), **dataclasses.asdict(encoder.cfg)}
    want = ref_whisper.features(dict(encoder.state_dict()), ref_cfg, wav)
    rel = float(((out - want).flatten(1).norm(dim=1)
                 / want.flatten(1).norm(dim=1)).max())
    log(f"phase 6e Whisper serve p50 {statistics.median(req_ms):.3f} ms "
        f"over {N_REQUESTS} requests of {W} windows (one 30 s utterance "
        f"each); bias-free K2 launches {served}; codes == host staging; "
        f"features against the plain reference: relative error {rel:.3e} "
        f"(tol {WHISPER_FEAT_RTOL})")
    if rel > WHISPER_FEAT_RTOL:
        raise SystemExit(f"Whisper features differ from the reference by "
                         f"{rel}")
    del encoder, server, engine, out, want
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, ms=ms["kernel"], plain_ms=ms["plain"],
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=ms["library"]), served


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


def check_codes(name: str, vq_gpu, norm, got, want,
                tol: float = CODE_GAP_RTOL) -> None:
    """VQ codes of the card against the CPU port's (check_code_flips), the
    latent of window n from the card's encoder."""
    import numpy as np
    import torch

    def latent(n):
        with torch.no_grad():
            return vq_gpu.encoders[0](torch.as_tensor(
                norm[n:n + 1].astype(np.float32), device=vq_gpu.device))[0]
    check_code_flips(name, latent, vq_gpu.codebook, got, want, tol)


def check_code_flips(name: str, latent, codebook, got, want,
                     tol: float = CODE_GAP_RTOL) -> None:
    """Codes of the card against the CPU port's. Where they differ, the
    two candidates' squared distances from the card's latent (``latent(n)``
    of window n, (T, D)) are compared: a flip is accepted only between
    candidates whose distances differ by float32 rounding (relative to the
    terms the distance sums; ``tol``)."""
    import numpy as np
    diff = np.argwhere(got != want)
    gaps = []
    k = codebook.double().cpu().numpy()
    for n, t in diff:
        x = latent(n)[t].double().cpu().numpy()
        a, b = k[got[n, t]], k[want[n, t]]
        da, db = ((x - a) ** 2).sum(), ((x - b) ** 2).sum()
        scale = (x ** 2).sum() + max((a ** 2).sum(), (b ** 2).sum())
        gaps.append(abs(da - db) / scale)
        log(f"{name} code differs at window {n} slot {t}: card "
            f"{got[n, t]} vs CPU {want[n, t]}, distance gap {da - db:+.3e} "
            f"(relative {gaps[-1]:.3e}, tol {tol})")
    if gaps and max(gaps) > tol:
        raise SystemExit(f"{name}: card codes differ from the CPU port's by "
                         f"more than float32 rounding")
    log(f"{name} codes: {got.size - len(diff)}/{got.size} equal to "
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
        check_codes(f"phase 15 encode_windows {s}", vq_gpu, norm[s], codes[s],
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


def _feat_bytes(feat) -> int:
    parts = feat if isinstance(feat, tuple) else (feat,)
    return sum(t.numel() * t.element_size() for t in parts)


def _cosine_f64(q, dn):
    """float64 evaluation of the port's cosine products over the same
    rounded operands (the query split as cosine_distance_prenorm splits
    it): hi.hi + hi.lo + lo.hi for a (hi, lo) database, one product of the
    query cast to the database's 16-bit type otherwise."""
    from qpgesture_tpu_torch.match import engine as eng
    from qpgesture_tpu_torch.ops.precision import split_bf16
    qn = eng._l2_normalize(q)
    if isinstance(dn, tuple):
        q_hi, q_lo = (t.double() for t in split_bf16(qn))
        d_hi, d_lo = (t.double() for t in dn)
        return 1.0 - (q_hi @ d_hi.T + q_hi @ d_lo.T + q_lo @ d_hi.T)
    return 1.0 - qn.to(dn.dtype).double() @ dn.double().T


def _flip_gaps(dist_ref, rank_ref, rank_new):
    """Where the per-code ranks of one query row differ, the gap between
    each moved code's reference distance and that of the code holding its
    old rank now: how near a tie the flip was."""
    import numpy as np
    moved = np.nonzero(rank_ref != rank_new)[0]
    holder = {int(r): c for c, r in enumerate(rank_new)}
    return [abs(float(dist_ref[c]) - float(dist_ref[holder[int(rank_ref[c])]]))
            for c in moved]


def phase16_tables(dev, shipped, vqvae_gpu, data_mean, data_std):
    """shipped_fast ("high", bf16x3) and "default" cosine tables, then
    bf16 / f16 residency, on phase 7's database, weights and requests."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.core.config import MATCH_PRESETS
    from qpgesture_tpu_torch.match import engine as eng
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.serve import RawWavServer

    db, wavs, ctxs = shipped["db"], shipped["wavs"], shipped["ctxs"]
    base = shipped["engine"]
    want_codes = np.stack(shipped["codes"])
    flat = db.aud_feat.reshape(-1, db.aud_feat.shape[-1])
    server0 = RawWavServer(base, vqvae_gpu, shipped["enc_gpu"], data_mean,
                           data_std)
    staged = [server0.stage(server0.encode(wavs[r]), ctxs[r])
              for r in range(N_REQUESTS)]
    rows = torch.arange(512, device=dev) * (flat.shape[0] // 512)

    def tables_ms(cfg, devdb, ta, tc):
        with uncounted():
            return median_ms(lambda: eng._tables_impl(cfg, devdb, ta, tc),
                             10)

    def cosine_ms(q, feat):
        """(device ms of the audio cosine products alone, their bound: the
        database and the queries read once and the (Q, N) float32
        distances written once over HBM bandwidth, or 2QND operations per
        product over the rate of the operands' type)"""
        n_bytes = _feat_bytes(feat) + q.numel() * 4 + 4 * q.shape[0] * N
        products = 3 if isinstance(feat, tuple) else 1
        rate = F32_FLOPS if products == 1 and feat.dtype == torch.float32 \
            else BF16_TC_FLOPS
        ops_ms = 1e3 * products * 2 * q.shape[0] * N * q.shape[1] / rate
        bound = max(ops_ms, 1e3 * n_bytes / HBM_BYTES_PER_S)
        return device_ms(lambda: eng.cosine_distance_prenorm(q, feat), 20), \
            bound

    N = flat.shape[0]
    ms_highest = tables_ms(base.cfg, base.devdb, *staged[0])
    q48 = staged[0][0].reshape(-1, flat.shape[1])
    cos_highest = cosine_ms(q48, base.devdb.aud_feat)

    def staged_bytes(cfg):
        """(engine, the device bytes that its construction and its
        database's staging, on first use, left allocated)"""
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        engine = eng.CodeKNNEngine(cfg, db, device=dev)
        engine.devdb
        torch.cuda.synchronize()
        return engine, torch.cuda.memory_allocated() - m0

    # a float32 engine staged the same way: what it holds besides the audio
    # features (the text features, phase / amp, signature ranks) is common
    f32_engine, f32_bytes = staged_bytes(base.cfg)
    common = f32_bytes - flat.nbytes
    del f32_engine
    log(f"phase 16 set-up: \"highest\" tables_ms={ms_highest:.4f} at Q="
        f"{W * 8}; a float32 engine holds {f32_bytes / 1e6:.1f} MB "
        f"(memory_allocated), its audio features {flat.nbytes / 1e6:.1f} MB")

    configs = [
        ("shipped_fast", MATCH_PRESETS["shipped_fast"], 1e-4),
        ("default", dataclasses.replace(MATCH_PRESETS["shipped"],
                                        cosine_precision="default"), 1e-4),
        ("bfloat16", dataclasses.replace(MATCH_PRESETS["shipped"],
                                         feat_dtype="bfloat16"), 1e-5),
        ("float16", dataclasses.replace(MATCH_PRESETS["shipped"],
                                        feat_dtype="float16"), 1e-5),
    ]
    fast = None
    for name, cfg, tol in configs:
        engine, n_bytes = staged_bytes(cfg)
        feat = engine.devdb.aud_feat
        share = (n_bytes - common) / flat.nbytes    # of the float32 features
        # the resident database: the split of the card's normalized rows,
        # or the host's staging uploaded
        if cfg.feat_dtype != "float32":
            host = eng.stage_cosine_features(flat, cfg.feat_dtype)
            if not torch.equal(feat.cpu(), host):
                raise SystemExit(f"{name}: the staged database differs from "
                                 f"the CPU port's host staging")
            if not 0.45 <= share <= 0.55:
                raise SystemExit(f"{name} residency takes {share:.3f} of "
                                 f"float32's bytes")
        # distances over 512 database rows against float64 products of
        # the same rounded operands
        q = staged[0][0].reshape(-1, staged[0][0].shape[-1])
        sub = tuple(t[rows] for t in feat) if isinstance(feat, tuple) \
            else feat[rows]
        got = eng.cosine_distance_prenorm(q, sub)
        err = float((got.double() - _cosine_f64(q, sub)).abs().max())
        if not err <= tol:
            raise SystemExit(f"{name}: distances differ from float64 by "
                             f"{err:.3e} (tol {tol})")
        server = RawWavServer(engine, vqvae_gpu, shipped["enc_gpu"],
                              data_mean, data_std)

        def serve(r):
            return server.serve(wavs[r], ctxs[r], init_code=0,
                                rng=np.random.RandomState(cfg.seed))

        serve(0)
        torch.cuda.synchronize()
        before = K2.launches
        req_ms, codes = [], []
        for r in range(N_REQUESTS):
            t0 = time.perf_counter()
            codes.append(serve(r)[0])
            req_ms.append(1e3 * (time.perf_counter() - t0))
        k2_served = K2.launches - before
        codes = np.stack(codes)
        same = codes == want_codes
        ms = tables_ms(cfg, engine.devdb, *staged[0])
        cos = cosine_ms(q48, feat)
        log(f"phase 16 {name}: engine {n_bytes / 1e6:.1f} MB by "
            f"memory_allocated, its audio features {share:.3f} of float32's "
            f"bytes; audio features "
            f"{_feat_bytes(feat) / 1e6:.1f} MB, estimate_devdb_bytes "
            f"{eng.estimate_devdb_bytes(cfg, db) / 1e6:.1f} MB; distances vs "
            f"float64 over 512 rows max_abs_err {err:.3e} (tol {tol}); "
            f"tables_ms={ms:.4f} (\"highest\" {ms_highest:.4f}); cosine "
            f"products device {cos[0]:.4f} ms, bound {cos[1]:.4f} "
            f"(\"highest\" {cos_highest[0]:.4f}, bound {cos_highest[1]:.4f});"
            f" serve p50 "
            f"{statistics.median(req_ms):.3f} ms over {N_REQUESTS} requests "
            f"(K2 launches {k2_served}); index_agreement with \"highest\" "
            f"{same.mean():.4f} ({int(same.sum())}/{same.size})")
        for r in range(N_REQUESTS):
            if same[r].all():
                continue
            ta, tc = staged[r]
            with uncounted():
                t_ref = eng._tables_impl(base.cfg, base.devdb, ta, tc)
                t_new = eng._tables_impl(cfg, engine.devdb, ta, tc)
                d_ref = eng._raw_tables_impl(base.cfg, base.devdb, ta,
                                             tc)[0][0]
            gaps = []
            for qi in range(ta.shape[0] * ta.shape[1]):
                gaps += _flip_gaps(d_ref[qi].cpu().numpy(),
                                   t_ref.aud_rank[qi].cpu().numpy(),
                                   t_new.aud_rank[qi].cpu().numpy())
            log(f"phase 16 {name} request {r}: differing (window, slot) "
                f"{[tuple(map(int, i)) for i in np.argwhere(~same[r])][:12]};"
                f" {len(gaps)} per-code rank flips, \"highest\" distance gap "
                f"of the flipped candidates max {max(gaps, default=0):.3e}")
        if name == "shipped_fast":
            fast = (cfg, engine)
            with uncounted():
                log_profile("phase 16 \"highest\" tables at Q=48", lambda: (
                    eng._tables_impl(base.cfg, base.devdb, *staged[0]),
                    torch.cuda.synchronize()))
                log_profile("phase 16 \"high\" tables at Q=48", lambda: (
                    eng._tables_impl(cfg, engine.devdb, *staged[0]),
                    torch.cuda.synchronize()))
        else:
            del engine, server

    # one predict_batch of C=8 shipped_fast clips: lanes == solo predict
    cfg, engine = fast
    C = 8
    clips = [staged[r % N_REQUESTS] for r in range(C)]
    ta = torch.stack([c[0] if i < N_REQUESTS else c[0].flip(0)
                      for i, c in enumerate(clips)]).cpu().numpy()
    tc = torch.stack([c[1] if i < N_REQUESTS else c[1].flip(0)
                      for i, c in enumerate(clips)]).cpu().numpy()
    inits = np.arange(C, dtype=np.int32) * 61
    phases0 = np.random.RandomState(SEED).rand(C, 8, 16).astype(np.float32)
    lanes = engine.predict_batch(ta, tc, init_codes=inits,
                                 init_phases=phases0)
    for c in range(C):
        solo = engine.predict(ta[c], tc[c], init_code=int(inits[c]),
                              init_phase=phases0[c])
        if not (np.array_equal(lanes[c].codes, solo.codes)
                and np.array_equal(lanes[c].phases, solo.phases)):
            raise SystemExit(f"shipped_fast predict_batch lane {c} differs "
                             f"from solo predict")
    qa = torch.as_tensor(ta.reshape((C * W,) + ta.shape[2:]), device=dev)
    qc = torch.as_tensor(tc.reshape((C * W,) + tc.shape[2:]), device=dev)
    ms_high = tables_ms(cfg, engine.devdb, qa, qc)
    ms_f32 = tables_ms(base.cfg, base.devdb, qa, qc)
    q384 = qa.reshape(-1, flat.shape[1])
    cos_high = cosine_ms(q384, engine.devdb.aud_feat)
    cos_f32 = cosine_ms(q384, base.devdb.aud_feat)
    log(f"phase 16 shipped_fast predict_batch C={C} W={W}: every lane == "
        f"solo predict; tables_ms at Q={C * W * 8}: \"high\" {ms_high:.4f}, "
        f"\"highest\" {ms_f32:.4f} (x{ms_f32 / ms_high:.2f}); cosine "
        f"products device \"high\" {cos_high[0]:.4f} ms (bound "
        f"{cos_high[1]:.4f}), \"highest\" {cos_f32[0]:.4f} ms (bound "
        f"{cos_f32[1]:.4f})")


def phase16_reference_ties(dev, serving, reference, requests, bundle, codes,
                           signature, wavvq):
    """Reference-ties matching on phase 4's J=1024 wavvq database: K1 on
    the card, the host fusion, against the CPU port, and on an
    8-sequence subsample against the full reference-ties oracle."""
    import numpy as np
    from qpgesture_tpu_torch.match import engine as eng
    from qpgesture_tpu_torch.match.database import stage_database
    from qpgesture_tpu_torch.match.oracle import CodeKNNOracle
    from qpgesture_tpu_torch.pipelines.release import _take_bundle

    card, cpu = serving.engine, reference.engine
    cfg = card.cfg
    agree = []
    for r, (ta, tc) in enumerate(requests[:N_REQUESTS]):
        rng = lambda: np.random.RandomState(cfg.seed)
        got = card.predict_reference_ties(ta, tc, rng=rng())
        want = cpu.predict_reference_ties(ta, tc, rng=rng())
        if not (np.array_equal(got.codes, want.codes)
                and np.array_equal(got.phases, want.phases)
                and np.array_equal(got.votes, want.votes)):
            raise SystemExit(f"reference ties, request {r}: the card differs "
                             f"from the CPU port")
        stable = card.predict(ta, tc, rng=rng())
        agree.append(float((stable.codes == got.codes).mean()))
    ta, tc = requests[0]
    W_, S = ta.shape[:2]
    qa, qc = card.stage_queries(ta, tc)
    with uncounted():
        raw = [[t.cpu().numpy() for t in side]
               for side in eng._raw_tables_impl(cfg, card.devdb, qa, qc)]
    aud = card._host_tables("aud", *raw[0], W_, S)
    txt = card._host_tables("txt", *raw[1], W_, S)
    oracle = CodeKNNOracle(card.db, tie_kind="reference")
    t0 = time.perf_counter()
    oracle.predict_with_tables(aud, txt, rng=np.random.RandomState(cfg.seed))
    fusion_ms = 1e3 * (time.perf_counter() - t0)
    with uncounted():
        call_ms = median_ms(lambda: card.predict_reference_ties(
            ta, tc, rng=np.random.RandomState(cfg.seed)), 3, warmup=0)

    sub = 8
    db_s = stage_database(cfg, _take_bundle(bundle, sub), codes[:sub],
                          signature, wavvq=wavvq[:sub])
    t0 = time.time()
    got = eng.CodeKNNEngine(cfg, db_s, device=dev).predict_reference_ties(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    want = CodeKNNOracle(db_s, tie_kind="reference").predict(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    if not np.array_equal(got.codes, want.codes):
        raise SystemExit("reference ties on the 8-sequence subsample differ "
                         "from the reference-ties oracle")
    log(f"phase 16 reference ties: J={J} wavvq, {N_REQUESTS} requests, card "
        f"== CPU port (codes, phases, votes; integer distances); stable vs "
        f"reference tie agreement {[round(a, 4) for a in agree]}; host "
        f"fusion {fusion_ms:.3f} ms of a {call_ms:.3f} ms call; J={sub} "
        f"subsample == CodeKNNOracle(tie_kind='reference').predict over "
        f"{W_} windows ({time.time() - t0:.1f} s)")


def phase16_release(tmp, bundle, codes, signature, wavvq, clips, vqvae_cpu):
    """verify-release --device cuda on a synthetic tree in the published
    layout written from phase 4's arrays (dense phases, uncompressed)."""
    import contextlib
    import io

    import numpy as np
    import torch
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.schemas import load_result
    from qpgesture_tpu_torch.pipelines.release import verify_release

    t0 = time.time()
    root = os.path.join(tmp, "release")
    spk = os.path.join(root, "data", "BEAT", "speaker_2_state_0")
    sig_dir = os.path.join(root, "data", "BEAT", "BEAT_output_60fps_rotation")
    ex = os.path.join(root, "data", "Example1", "ZeroEGGS_cut")
    pm = os.path.join(root, "pretrained_model")
    for d in (spk, sig_dir, ex, pm):
        os.makedirs(d)
    stem = os.path.join(spk, "speaker_2_state_0")
    np.savez(f"{stem}_train_240_txt_2.npz", context=bundle.context,
             phase=bundle.phase)
    np.savez(f"{stem}_test_240_txt_2.npz", context=clips[0][1])
    np.savez(f"{stem}_train_240_code.npz", code=codes)
    np.savez(f"{stem}_train_240_WavVQ.npz", wavvq=wavvq)
    np.savez(os.path.join(sig_dir, "code.npz"), code=signature.code,
             poses=signature.poses, signature=signature.signature)
    np.savez(os.path.join(ex, "wavvq_240.npz"), wavvq=clips[0][0])
    torch.save({"model_dict": vqvae_cpu.state_dict()},
               os.path.join(pm, "codebook_checkpoint_best.bin"))
    t1 = time.time()
    out = os.path.join(tmp, "release_result.npz")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cli(["verify-release", root, "--device", "cuda", "--out", out])
    card = json.loads(text.getvalue())
    t2 = time.time()
    lib_out = os.path.join(tmp, "release_result_lib.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        lib = verify_release(root, out=lib_out, device="cuda")
    bad = [k for k, v in card["checks"].items() if not v["ok"]]
    if bad or not card["ok"]:
        raise SystemExit(f"verify-release failed gates {bad}")
    if {k: v["ok"] for k, v in card["checks"].items()} != \
            {k: v["ok"] for k, v in lib["checks"].items()} or \
            not np.array_equal(load_result(out), load_result(lib_out)):
        raise SystemExit("the verify-release CLI differs from the library")
    log(f"phase 16 verify-release --device cuda: every gate ok, result == "
        f"the library call's; tree written in {t1 - t0:.1f} s, CLI "
        f"{t2 - t1:.1f} s; scorecard:")
    for name, check in card["checks"].items():
        log(f"    {name}: {json.dumps(check)}")
    log(f"    stable_vs_reference_tie_agreement: "
        f"{card['stable_vs_reference_tie_agreement']}")


# phase 16b: the fusion scan kernel (K3) against its plain loop at full
# width, on phase 4's (wavvq) and phase 7's (shipped) J=1024 databases
P16B_SCAN_ROUNDS = 7
# the scan's timing: lanes of the batch case, kernel calls a device_ms
# repetition, and load_chain's dependent loads over a random cycle through
# P16B_CHAIN_MB MiB (inside the 50 MB L2, and far past it)
P16B_SCAN_LANES, P16B_KERNEL_CALLS = 16, 20
P16B_CHAIN_LOADS, P16B_CHAIN_MB = 200_000, (8, 1024)


def phase16b_scan(dev, serving, requests, shipped, smi: str) -> dict:
    """The fusion scan at full width: the engines' resident bytes, then
    phase16b_scan_times on a staged wavvq request (K1's tables), a shipped
    request (phase 7's card features of its first clip, host-staged) and
    P16B_SCAN_LANES wavvq clips. Returns K3's times."""
    import numpy as np
    from qpgesture_tpu_torch.core import constants as const
    from qpgesture_tpu_torch.match.database import (stage_test_audio,
                                                    stage_test_context)

    rng = np.random.RandomState(SEED + 16)
    engines = {"wavvq": serving.engine, "shipped": shipped["engine"]}
    for preset, e in engines.items():
        log(f"phase 16b {preset} engine (J={J}): DeviceDatabase "
            f"{tensor_bytes(e.dev) / 1e6:.3f} MB, of which phase / amp "
            f"{tensor_bytes(e.dev.phase, e.dev.amp) / 1e6:.3f} MB; the "
            f"staged database beside it {tensor_bytes(e.devdb) / 1e6:.1f} "
            f"MB; {smi}")
    cfg_s, db_s = shipped["cfg"], shipped["db"]
    ta_s = stage_test_audio(cfg_s, db_s,
                            wavlm=shipped["feats"].cpu().numpy())
    tc_s = stage_test_context(db_s, shipped["ctxs"][0])
    cfg_w, db_w = serving.engine.cfg, serving.engine.db
    ta_16 = np.stack([stage_test_audio(cfg_w, db_w, wavvq=rng.randint(
        0, const.WAVVQ_VOCAB, size=(W, const.WAVVQ_FRAMES, 2)
    ).astype(np.int32)) for _ in range(P16B_SCAN_LANES)])
    tc_16 = np.stack([stage_test_context(db_w, rng.randn(
        W, 30, 1, 384).astype(np.float32)) for _ in range(P16B_SCAN_LANES)])
    return phase16b_scan_times(
        dev, engines, {"wavvq": requests[0], "shipped": (ta_s, tc_s)},
        (ta_16.reshape((-1,) + ta_16.shape[2:]),
         tc_16.reshape((-1,) + tc_16.shape[2:])), smi)


# The yardstick of the fusion scan's bound: one thread follows next[] n
# times from entry 0, n dependent loads.
LOAD_CHAIN_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void load_chain(const int64_t* next, int64_t n, int64_t* out) {
  int64_t i = 0;
  for (int64_t k = 0; k < n; ++k) i = next[i];
  *out = i;
}
extern "C" int qpg_load_chain(const int64_t* next, int64_t n, int64_t* out,
                              void* stream) {
  load_chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, n, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def load_latency_ns(dev, sizes_mb) -> dict:
    """{mb: device ns of one dependent load} for each size: LOAD_CHAIN_CU
    (built with the port's nvcc flags) over a random cycle through mb MiB
    of int64 entries."""
    import ctypes
    import torch
    from qpgesture_tpu_torch.ops import cuda_build
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "chain.cu"), os.path.join(tmp, "chain.so")
        with open(src, "w") as f:
            f.write(LOAD_CHAIN_CU)
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
                        src], check=True, capture_output=True, timeout=300)
        chain = ctypes.CDLL(lib).qpg_load_chain
    chain.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_void_p]
    chain.restype = ctypes.c_int
    out = torch.empty((1,), dtype=torch.int64, device=dev)

    def run(nxt):
        err = chain(nxt.data_ptr(), P16B_CHAIN_LOADS, out.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise SystemExit(f"load chain launch failed (cudaError {err})")

    lat = {}
    for mb in sizes_mb:
        order = torch.randperm((mb << 20) // 8, device=dev)
        nxt = torch.empty_like(order)
        nxt[order] = order.roll(-1)
        lat[mb] = device_ms(lambda: run(nxt), 1, reps=3) * 1e6 / \
            P16B_CHAIN_LOADS
    return lat


def phase16b_scan_times(dev, engines, requests, batch, smi: str) -> dict:
    """The fusion scan kernel against its plain loop on the card, on one
    request's tables (Q = W x 8, one lane; each preset) and on
    P16B_SCAN_LANES wavvq clips' (lanes of L = W x 8): the two equal
    bit for bit; the kernel's device ms (P16B_KERNEL_CALLS calls behind a
    spin) and one call's ms (CUDA events around it, its host launch
    included) beside its bound, L dependent loads at LOAD_CHAIN_CU's
    latency in L2 and past it; the loop's ms a call and its device busy ms (the
    profiler's union of its operations). engines: {preset: engine};
    requests: {preset: (ta, tc)} of one clip; batch: (ta, tc) of the lanes'
    windows. Selection is tabulated once, outside the timed calls. Returns
    the kernels line's K3 times, of the first case (a wavvq request)."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.match import engine as eng
    from qpgesture_tpu_torch.ops import fusion_scan_cuda as K3
    from qpgesture_tpu_torch.utils.profiling import device_busy

    lat = load_latency_ns(dev, P16B_CHAIN_MB)
    log("phase 16b dependent-load latency (LOAD_CHAIN_CU, "
        f"{P16B_CHAIN_LOADS} loads through a random cycle): "
        + ", ".join(f"{mb} MiB {ns:.1f} ns" for mb, ns in lat.items())
        + f"; {smi}")
    cases = [(preset, engines[preset], *requests[preset], 1)
             for preset in requests]
    cases.append(("wavvq", engines["wavvq"], *batch, P16B_SCAN_LANES))
    times, max_err = None, 0.0
    for preset, e, ta, tc, C in cases:
        cfg = e.cfg
        qa, qc = e.stage_queries(ta, tc)
        tables = e.tables(qa, qc)
        S = tables.n_steps
        Q = (qa if qa is not None else qc).shape[0] * S
        L = Q // C
        mask = np.zeros((L,), bool)
        mask[0] = True
        args = (cfg, S, C, (cfg.num_frames_code - 1) % cfg.step_sz, e.dev,
                tables, eng._tabulate_selection(cfg, e.dev, tables,
                                                eng._int_scale(cfg)),
                mask, None,
                torch.arange(Q, device=e.device) % cfg.codebook_size,
                torch.zeros((Q, 8, 16), device=e.device))
        before = K3.launches
        got, want = eng._scan_kernel(*args), eng._scan_loop(*args)
        if K3.launches != before + 1 or \
                not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"phase 16b {preset} C={C}: the fusion scan "
                             f"kernel differs from its plain loop")
        max_err = max([max_err] + [float((g.double() - w.double()).abs()
                                         .max()) for g, w in zip(got, want)])
        k_dev = device_ms(lambda: eng._scan_kernel(*args), P16B_KERNEL_CALLS)
        k_call = median_ms(lambda: eng._scan_kernel(*args), P16B_SCAN_ROUNDS)
        loop_call = median_ms(lambda: eng._scan_loop(*args), P16B_SCAN_ROUNDS)
        # the loop's thousands of launches fill CUDA's launch queue behind
        # device_ms's spin: its device time is the profiler's busy time
        loop_dev = device_busy(lambda: eng._scan_loop(*args))[0] * 1e3
        bound = {mb: L * ns * 1e-6 for mb, ns in lat.items()}
        log(f"phase 16b fusion scan {preset} C={C} L={L}: kernel == "
            f"loop (blocks, phases, votes); kernel device {k_dev:.4f} ms, "
            f"a call {k_call:.4f} ms; bound (L dependent loads) "
            + ", ".join(f"{bound[mb]:.4f} ms at {mb} MiB's latency"
                        for mb in P16B_CHAIN_MB)
            + f"; loop a call {loop_call:.3f} ms, device {loop_dev:.3f} ms "
            f"(x{loop_call / k_call:.0f} the kernel's call); {smi}")
        if times is None:
            mb = P16B_CHAIN_MB[0]
            times = {"ms": k_dev, "plain_ms": loop_call,
                     "bound_ms": bound[mb],
                     "bound_by": f"{L} dependent loads at {lat[mb]:.1f} ns "
                                 f"({mb} MiB chain, in L2); {preset} "
                                 f"C={C}",
                     "library_ms": None}
    return {"max_abs_err": max_err, **times}


def phase16_resync_end2end(dev, rng, tmp, vqvae_cpu):
    """generate --resync and resync-apply with a full-width random
    ResyncNet, generate --model end2end with a full-width random
    GeneratorGRU, each against the CPU port."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.cli import _end2end_windows, _make_resync_transform
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.schemas import DatabaseBundle
    from qpgesture_tpu_torch.models.convert import (
        load_generator_gru_checkpoint, load_resync_checkpoint)
    from qpgesture_tpu_torch.models.gru_baseline import GeneratorGRU
    from qpgesture_tpu_torch.models.resync import (ResyncNet,
                                                   predict_resynced_gesture,
                                                   resync_stats)
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    from qpgesture_tpu_torch.motion.pipeline import MotionPipeline
    from qpgesture_tpu_torch.pipelines.audio_prep import write_wav
    from qpgesture_tpu_torch.render.decode import decode_codes

    p = lambda name: os.path.join(tmp, name)
    gen = torch.Generator().manual_seed(SEED)

    def randomize_bn(model):
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm1d):
                    m.running_mean.copy_(0.1 * torch.randn(
                        m.num_features, generator=gen))
                    m.running_var.copy_(0.5 + torch.rand(
                        m.num_features, generator=gen))

    torch.manual_seed(SEED)
    resync_cpu = ResyncNet(device="cpu")       # 13 + 135 in, 135 out
    randomize_bn(resync_cpu)
    torch.save({"model_resync_state_dict": resync_cpu.state_dict()},
               p("best_model.pth"))
    gru_cpu = GeneratorGRU(device="cpu")       # hidden 200, 512 codes
    randomize_bn(gru_cpu)
    torch.save({"model_dict": gru_cpu.state_dict()}, p("end2end.bin"))
    torch.save({"model_dict": vqvae_cpu.state_dict()}, p("vqvae.bin"))
    pipe = MotionPipeline(fps=60).fit(parse_bvh(skeleton_bvh_text(rng)))
    with open(p("pipeline.json"), "w") as f:
        f.write(pipe.to_json())
    stats_bundle = DatabaseBundle(
        mfcc=rng.randn(64, 240, 14).astype(np.float32),
        body=(rng.randn(64, 240, 135) * 0.5).astype(np.float32))
    np.savez(p("train_db.npz"), mfcc=stats_bundle.mfcc,
             body=stats_bundle.body)
    wav24 = (rng.randn(24 * 16000) * 0.1).astype(np.float32)
    write_wav(p("speech24.wav"), wav24, 16000)
    wav60 = (rng.randn(60 * 16000) * 0.1).astype(np.float32)
    write_wav(p("speech60.wav"), wav60, 16000)
    common = ["--model", "end2end", "--end2end-checkpoint", p("end2end.bin"),
              "--vqvae-checkpoint", p("vqvae.bin"),
              "--pipeline", p("pipeline.json")]

    # -- resync: generate --resync over a 24 s request's decoded motion ----
    t0 = time.time()
    cli(["generate", "--wav", p("speech24.wav"), *common,
         "--resync", p("best_model.pth"), "--train-database",
         p("train_db.npz"), "--out", p("gen_resync"), "--prefix", "r"])
    bvh = parse_bvh(p(os.path.join("gen_resync", "r_generated.bvh")))
    if bvh.values.shape != (W * 240, len(bvh.channel_names)) or \
            not np.isfinite(bvh.values).all():
        raise SystemExit(f"generate --resync BVH {bvh.values.shape}")
    codes24 = np.load(p(os.path.join("gen_resync", "code_r.npy")))
    wav24_read = load_wav(p("speech24.wav"))
    poses = decode_codes(vqvae_cpu, codes24)
    out_card = _make_resync_transform(p("best_model.pth"), wav24_read,
                                      stats_bundle, dev)(poses)
    out_cpu = _make_resync_transform(p("best_model.pth"), wav24_read,
                                     stats_bundle, torch.device("cpu"))(poses)
    scale = float(out_cpu.std())
    err = float(np.abs(out_card - out_cpu).max())
    if not err <= 1e-3 * scale:
        raise SystemExit(f"generate --resync: card vs CPU {err:.3e} (motion "
                         f"std {scale:.3f})")
    log(f"phase 16 generate --resync (24 s, end2end codes): BVH "
        f"{bvh.values.shape}; the resync transform card vs CPU port "
        f"max_abs_err {err:.3e} (tol 1e-3 x motion std {scale:.3f}); "
        f"{time.time() - t0:.1f} s")

    # -- resync-apply over N=64 x 240 frames -------------------------------
    N = 64
    knn = (rng.randn(N, 135, 240) * 0.5).astype(np.float32)
    np.savez(p("knn.npz"), knn_pred=knn)
    np.savez(p("test_mfcc.npz"), mfcc=rng.randn(N, 240, 14).astype(
        np.float32))
    outs = {}
    for d in ("cuda", "cpu"):
        t0 = time.time()
        cli(["resync-apply", "--knn", p("knn.npz"), "--test-data",
             p("test_mfcc.npz"), "--train-database", p("train_db.npz"),
             "--checkpoint", p("best_model.pth"), "--out",
             p(f"stage2_{d}.npz"), "--device", d])
        outs[d] = (np.load(p(f"stage2_{d}.npz"))["knn_pred"],
                   time.time() - t0)
    scale = float(outs["cpu"][0].std())
    err = float(np.abs(outs["cuda"][0] - outs["cpu"][0]).max())
    if outs["cuda"][0].shape != knn.shape or not err <= 1e-3 * scale:
        raise SystemExit(f"resync-apply: card vs CPU {err:.3e} (motion std "
                         f"{scale:.3f})")
    gen_card = load_resync_checkpoint(p("best_model.pth"), device=dev)
    mf = np.load(p("test_mfcc.npz"))["mfcc"][:, :, :13]
    stats = resync_stats(stats_bundle.mfcc[:, :, :13], stats_bundle.body)
    motion = knn.transpose(0, 2, 1)
    resync_ms = median_ms(lambda: predict_resynced_gesture(
        gen_card, mf, motion, *stats), 5)
    x = torch.randn(N, 148, 240, device=dev)
    with torch.no_grad():
        fwd_ms = device_ms(lambda: gen_card(x), 10)
    log(f"phase 16 resync-apply N={N} x 240 frames: card vs CPU port "
        f"max_abs_err {err:.3e} (tol 1e-3 x motion std {scale:.3f}); CLI "
        f"{outs['cuda'][1]:.1f} s (cuda) / {outs['cpu'][1]:.1f} s (cpu); "
        f"resync_ms={resync_ms:.3f} (host arrays in and out), forward "
        f"device {fwd_ms:.3f} ms")
    with torch.no_grad():
        log_profile("phase 16 ResyncNet forward N=64", lambda: gen_card(x))

    # -- end2end: generate --model end2end --max-frames 3600 on 60 s -------
    t0 = time.time()
    cli(["generate", "--wav", p("speech60.wav"), *common, "--max-frames",
         "3600", "--out", p("gen_e2e"), "--prefix", "e"])
    got = np.load(p(os.path.join("gen_e2e", "code_e.npy")))
    wins = _end2end_windows(load_wav(p("speech60.wav")), 3600)
    with torch.no_grad():
        logits = gru_cpu(torch.from_numpy(wins))
    want = logits.argmax(-1).numpy()
    if got.shape != (15, 30) or want.shape != got.shape:
        raise SystemExit(f"end2end codes {got.shape}")
    for w, s in np.argwhere(got != want):
        top = torch.topk(logits[w, s], 2).values
        gap = float(top[0] - top[1])
        log(f"phase 16 end2end code ({w}, {s}): card {got[w, s]} vs CPU "
            f"{want[w, s]}, CPU top-2 logit gap {gap:.3e}")
        if gap > 1e-6 * float(top[0].abs()):
            raise SystemExit("end2end codes differ beyond float32 rounding")
    gru_card = load_generator_gru_checkpoint(p("end2end.bin"), device=dev)
    wins_d = torch.as_tensor(wins, device=dev)
    sample_ms = median_ms(lambda: gru_card.sample(wins_d), 10)
    with torch.no_grad():
        card_logits = gru_card(wins_d).cpu()
    same = got == want
    log(f"phase 16 generate --model end2end --max-frames 3600 (60 s, 15 "
        f"windows): codes equal to the CPU port's {int(same.sum())}/"
        f"{same.size}; logits card vs CPU max_abs_err "
        f"{float((card_logits - logits).abs().max()):.3e}; sample_ms="
        f"{sample_ms:.3f} (device, CUDA events); {time.time() - t0:.1f} s")
    kernels = log_profile("phase 16 GeneratorGRU.sample",
                          lambda: gru_card.sample(wins_d))
    rnn = [k for k in kernels if "rnn" in k.lower() or "gru" in k.lower()
           or "persist" in k.lower() or "elemWise" in k]
    log(f"phase 16 GRU kernels: {rnn[:6]}")


# -- phase 17: training on the card ------------------------------------------

def training_clips(rng, n_clips: int, frames: int):
    """Seeded synthetic pose clips with temporal structure: per channel a
    sum of three sinusoids (0.2-3 Hz at 60 fps, random phases) plus noise,
    (frames, 135) float32 each."""
    import numpy as np
    t = np.arange(frames)[:, None] / 60.0
    clips = []
    for _ in range(n_clips):
        x = np.zeros((frames, 135))
        for _ in range(3):
            f = rng.uniform(0.2, 3.0, 135)
            x += rng.uniform(0.1, 0.5, 135) * np.sin(
                2 * np.pi * f * t + rng.uniform(0, 2 * np.pi, 135))
        x += 0.05 * rng.randn(frames, 135) + rng.randn(135)
        clips.append({"poses": x.astype(np.float32)})
    return clips


def write_train_config(path: str, **top) -> None:
    """The trainers' YAML: TRAIN_SECTIONS, TRAIN_BATCH, checkpoints every
    2 epochs, and ``top``'s keys."""
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump({**TRAIN_SECTIONS, "batch_size": TRAIN_BATCH,
                        "save_per_epochs": 2, **top}, f)


def step_without_sync(step) -> None:
    """One call of step under torch's sync debug mode "error": a host sync
    inside it raises."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def grad_err(card_model, cpu_model, zero_grad=()):
    """(worst ||g_card - g_cpu|| / ||g_cpu|| over the tensors, worst largest
    element difference relative to that tensor's largest |g|). Tensors named
    in zero_grad (gradient 0 analytically, rounding noise on both devices)
    enter both as their largest difference relative to the model's largest
    |g|."""
    return grads_err({n: p.grad for n, p in card_model.named_parameters()},
                     {n: p.grad for n, p in cpu_model.named_parameters()},
                     zero_grad)


def grads_err(got: dict, ref: dict, zero_grad=()):
    """grad_err of two {name: gradient} dicts, ``ref`` the reference."""
    ref = {n: g.cpu() for n, g in ref.items()}
    top = max(float(g.abs().max()) for g in ref.values())
    norm_err = elem_err = 0.0
    for name, g in got.items():
        want = ref[name]
        diff = g.cpu() - want
        if name in zero_grad:
            e = float(diff.abs().max()) / top
            norm_err, elem_err = max(norm_err, e), max(elem_err, e)
            continue
        norm_err = max(norm_err, float(diff.norm() / want.norm()))
        elem_err = max(elem_err, float(diff.abs().max() / want.abs().max()))
    return norm_err, elem_err


def bn_stats_err(card_model, cpu_model):
    cpu_bufs = dict(cpu_model.named_buffers())
    return max([rel_err(b, cpu_bufs[n])
                for n, b in card_model.named_buffers() if "running" in n]
               or [0.0])


def rel_err(card, cpu) -> float:
    """Largest difference of two tensors relative to the CPU one's largest
    magnitude."""
    return float((card.cpu() - cpu).abs().max()) / max(
        float(cpu.abs().max()), 1e-30)


def time_trainer(name: str, step, windows: int, n: int = TRAIN_TIMED_STEPS,
                 phase: str = "phase 17"):
    """Step ms from CUDA events around n steps after 3 warm-up steps,
    windows/s, peak memory of those steps, and a profile of 3 steps (device
    busy, idle share, top kernels)."""
    import torch
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        step()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / n
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def three():
        for _ in range(3):
            step()
        torch.cuda.synchronize()

    log(f"{phase} {name}: step_ms={step_ms:.3f} over {n} steps (CUDA "
        f"events) = {1e3 * windows / step_ms:.1f} windows/s at batch "
        f"{windows}; peak max_memory_allocated {peak:.3f} GiB")
    log_profile(f"{phase} {name} 3 steps", three)
    return step_ms


def phase17_vqvae(dev, rng, tmp: str, pipeline):
    """train-vqvae at the shipped width (3 epochs with validation, then
    --resume for one more), decode and signature from the output
    directory, DeviceClipStore against the host batches, one step card
    against CPU at batch 8, a step under sync debug mode "error", and the
    step's time at batch 256. Returns the output directory."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.config import TrainConfig, VQVAEConfig
    from qpgesture_tpu_torch.core.schemas import CodebookSignature
    from qpgesture_tpu_torch.models.convert import load_vqvae_checkpoint
    from qpgesture_tpu_torch.models.vqvae import codebook_signature
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    from qpgesture_tpu_torch.train.checkpoints import restore_checkpoint
    from qpgesture_tpu_torch.train.data import (DeviceClipStore,
                                                WindowedDataset)
    from qpgesture_tpu_torch.train.train_vqvae import VQVAETrainer
    from qpgesture_tpu_torch.utils.metrics_log import ScalarHistory
    p = lambda *names: os.path.join(tmp, *names)

    t0 = time.time()
    clips = training_clips(rng, TRAIN_CLIPS + VAL_CLIPS, TRAIN_CLIP_FRAMES)
    flat = np.concatenate([c["poses"] for c in clips[:TRAIN_CLIPS]])
    mean, std = flat.mean(0), flat.std(0)
    train = WindowedDataset.from_clips(clips[:TRAIN_CLIPS], 240, 32,
                                       data_mean=mean, data_std=std)
    train.save(p("train"))
    WindowedDataset.from_clips(clips[TRAIN_CLIPS:], 240, 32, data_mean=mean,
                               data_std=std).save(p("val"))
    write_train_config(p("train.yml"), val_data_path=p("val"))
    log(f"phase 17 data: {TRAIN_CLIPS} + {VAL_CLIPS} clips of "
        f"{TRAIN_CLIP_FRAMES} frames (135 channels, sinusoids + noise), "
        f"{len(train)} train windows at stride 32; {time.time() - t0:.1f} s")

    # the device data path: one upload, windows gathered on the card
    store = DeviceClipStore(clips[:TRAIN_CLIPS], 240, 32, mean, std,
                            device=dev)
    got = next(iter(store.batches(TRAIN_BATCH, seed=0)))
    want = next(iter(WindowedDataset.load(p("train")).batches(TRAIN_BATCH,
                                                              seed=0)))
    if not np.array_equal(got.cpu().numpy(), want):
        raise SystemExit("DeviceClipStore batch differs from the host batch")

    out = p("vq")
    base = ["train-vqvae", "--config", p("train.yml"), "--data",
            p("train"), "--out", out, "--device", str(dev)]
    t0 = time.time()
    cli(base + ["--epochs", "3"])
    t_train = time.time() - t0
    t0 = time.time()
    cli(base + ["--epochs", "4", "--resume"])
    t_resume = time.time() - t0
    files = sorted(os.listdir(out))
    hist = ScalarHistory.read(os.path.join(out, "scalars.jsonl"))
    latest = restore_checkpoint(out, "latest")
    val = hist["val_err"]
    losses = [v for _, _, v in hist["loss"]]
    spe = len(train) // TRAIN_BATCH
    log(f"phase 17 train-vqvae: 3 epochs {t_train:.1f} s, --resume to 4 "
        f"{t_resume:.1f} s ({spe} steps of {TRAIN_BATCH} per epoch; CLI "
        f"wall, "
        f"validation and checkpoints included); files {files}; val_err by "
        f"epoch {[(e, round(v, 5)) for e, _, v in val]}; first-step loss "
        f"by epoch {[round(v, 5) for v in losses]}; latest step "
        f"{latest['step']} epoch {latest['epoch']}")
    if not {"best.pt", "latest.pt", "002.pt", "004.pt",
            "scalars.jsonl"} <= set(files):
        raise SystemExit(f"train-vqvae wrote {files}")
    if [e for e, _, _ in val] != [1, 2, 3, 4, 4, 5] or \
            (latest["step"], latest["epoch"]) != (4 * spe, 4):
        raise SystemExit("train-vqvae --resume numbered its epochs wrong")
    if not (losses[-1] < losses[0] and val[-1][2] < val[0][2]
            and np.isfinite(losses).all()):
        raise SystemExit("train-vqvae: the loss did not fall")

    # decode and signature from the output directory (its best.pt)
    cfg = VQVAEConfig(**TRAIN_SECTIONS["VQVAE"])
    np.savez(p("result.npz"), knn_pred=rng.randint(0, cfg.l_bins, (2, 30)))
    with open(p("pipeline.json"), "w") as f:
        f.write(pipeline.to_json())
    cli(["decode", "--result", p("result.npz"), "--checkpoint", out,
         "--config", p("train.yml"), "--pipeline", p("pipeline.json"),
         "--out", p("bvh"), "--prefix", "trained", "--device", str(dev)])
    bvh = parse_bvh(p("bvh", "trained_generated.bvh"))
    cli(["signature", "--checkpoint", out, "--config", p("train.yml"),
         "--out", p("code.npz"), "--device", str(dev)])
    vq_card = load_vqvae_checkpoint(out, cfg, device=dev)
    sig = CodebookSignature.load(p("code.npz"))
    _, _, want_sig = codebook_signature(vq_card)
    sig_err = float(np.abs(sig.signature - want_sig).max())
    log(f"phase 17 decode --checkpoint <out>: BVH {bvh.values.shape}; "
        f"signature --checkpoint <out>: {sig.signature.shape}, against "
        f"codebook_signature of best.pt's model {sig_err:.3e}")
    if bvh.values.shape[0] != 480 or not np.isfinite(bvh.values).all() \
            or sig_err > 0:
        raise SystemExit("decode / signature from the trained checkpoint")

    # one step card against CPU, full width at batch 8, from latest.pt
    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    cpu = VQVAETrainer(cfg, tcfg, steps_per_epoch=spe, device="cpu")
    card = VQVAETrainer(cfg, tcfg, steps_per_epoch=spe, device=dev)
    cpu.load_state_dict(latest)
    card.load_state_dict(restore_checkpoint(out, "latest"))
    x8 = got[:8].cpu()
    codes_cpu = cpu.model.encode(x8)
    codes_card = card.model.encode(x8.to(dev)).cpu()
    t0 = time.time()
    loss_cpu, _ = cpu.train_step(x8)
    t_cpu = time.time() - t0
    loss_card, metrics = card.train_step(x8.to(dev))
    a, b = card.model.codebook_block, cpu.model.codebook_block
    used = b.k_elem >= 1.0
    errs = {"loss": abs(float(loss_card) - float(loss_cpu))
            / float(loss_cpu),
            "grad": grad_err(card.model, cpu.model),
            "k_sum": rel_err(a.k_sum, b.k_sum),
            "k_elem": rel_err(a.k_elem, b.k_elem),
            "k_used": rel_err(a.k[used.to(dev)], b.k[used])}
    log(f"phase 17 VQ-VAE step card vs CPU port (full width, batch 8, from "
        f"latest.pt with its Adam state): loss rel {errs['loss']:.3e} "
        f"(tol {TRAIN_LOSS_RTOL}), gradients {errs['grad'][0]:.3e} (tol "
        f"{TRAIN_GRAD_RTOL}; largest element {errs['grad'][1]:.3e} of its "
        f"tensor's max), EMA k_sum {errs['k_sum']:.3e}"
        f" k_elem {errs['k_elem']:.3e} used rows of k {errs['k_used']:.3e} "
        f"of each tensor's max (tol {TRAIN_STATS_RTOL}); codes in use "
        f"{int(used.sum())} (card {int(metrics['usage'])}); CPU step "
        f"{t_cpu:.1f} s")
    check_codes("phase 17 VQ-VAE step batch", card.model, x8.numpy(),
                codes_card.numpy(), codes_cpu.numpy())
    if errs["loss"] > TRAIN_LOSS_RTOL or errs["grad"][0] > TRAIN_GRAD_RTOL or \
            max(errs["k_sum"], errs["k_elem"], errs["k_used"]) > \
            TRAIN_STATS_RTOL or not torch.equal(a.k_elem.cpu() >= 1.0, used):
        raise SystemExit("VQ-VAE training step: card differs from CPU")
    del cpu

    # the step on device-resident batches, with no host sync; its time
    trainer = VQVAETrainer(cfg, tcfg, steps_per_epoch=spe, device=dev)
    trainer.load_state_dict(restore_checkpoint(out, "latest"))
    x = next(iter(store.batches(TRAIN_BATCH, seed=1)))
    trainer.train_step(x)
    step_without_sync(lambda: trainer.train_step(x))
    log(f"phase 17 VQ-VAE step at batch {TRAIN_BATCH} under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")
    n_params = sum(q.numel() for q in trainer.model.parameters())
    time_trainer(f"VQ-VAE ({n_params} parameters, batch {TRAIN_BATCH} x "
                 "240 frames)", lambda: trainer.train_step(x), TRAIN_BATCH)
    if dev.type == "cuda":
        vqvae_heuristic_step()
    return out


def vqvae_heuristic_step(n: int = 5) -> None:
    """The same VQ-VAE step with cuDNN's heuristic algorithm choice (the
    trainer's cudnn_autotune replaced by a no-op), in a process of its own:
    cuDNN's plan cache would hand this one the timed choices already made."""
    code = f"""
import contextlib, sys, torch
sys.path.insert(0, {REPO!r})
import qpgesture_tpu_torch.train.train_vqvae as tv
from qpgesture_tpu_torch.core.config import TrainConfig, VQVAEConfig
tv.cudnn_autotune = contextlib.nullcontext
dev = torch.device("cuda")
g = torch.Generator(dev).manual_seed({SEED})
x = torch.randn({TRAIN_BATCH}, 240, 135, device=dev, generator=g)
tr = tv.VQVAETrainer(VQVAEConfig(**{TRAIN_SECTIONS['VQVAE']!r}),
                     TrainConfig(batch_size={TRAIN_BATCH}), device=dev)
tr.init_codebook(x)
for _ in range(2):
    tr.train_step(x)
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
start.record()
for _ in range({n}):
    tr.train_step(x)
end.record()
end.synchronize()
print(f"{{start.elapsed_time(end) / {n}:.3f}} "
      f"{{torch.cuda.max_memory_allocated() / 2 ** 30:.3f}}")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    if out.returncode:
        raise SystemExit(f"VQ-VAE heuristic step: {out.stderr[-2000:]}")
    step_ms, peak = out.stdout.split()[-2:]
    log(f"phase 17 VQ-VAE step with cuDNN's heuristic algorithms (no "
        f"autotune; a process of its own): step_ms={step_ms} over {n} steps "
        f"at batch {TRAIN_BATCH}; peak max_memory_allocated {peak} GiB")


def phase17_pae(dev, tmp: str):
    """train-pae at the PAE's configuration on phase 17's windows, one step
    card against CPU at batch 8, the step's time at batch 32. Returns the
    trained PAE (on the card)."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.config import PAEConfig
    from qpgesture_tpu_torch.models.convert import load_pae_checkpoint
    from qpgesture_tpu_torch.train.checkpoints import restore_checkpoint
    from qpgesture_tpu_torch.train.data import WindowedDataset
    from qpgesture_tpu_torch.train.train_pae import PAETrainer
    from qpgesture_tpu_torch.utils.metrics_log import ScalarHistory
    p = lambda *names: os.path.join(tmp, *names)

    out = p("pae")
    t0 = time.time()
    cli(["train-pae", "--config", p("train.yml"), "--data", p("train"),
         "--out", out, "--epochs", str(PAE_EPOCHS), "--device", str(dev)])
    losses = [v for _, _, v in ScalarHistory.read(
        os.path.join(out, "scalars.jsonl"))["loss"]]
    latest = restore_checkpoint(out, "latest")
    log(f"phase 17 train-pae: {PAE_EPOCHS} epochs {time.time() - t0:.1f} s "
        f"(batch 32, {latest['step']} steps; CLI wall); last-step loss by "
        f"epoch {[round(v, 5) for v in losses]}")
    if not (losses[-1] < losses[0] and np.isfinite(losses).all()):
        raise SystemExit("train-pae: the loss did not fall")

    cfg = PAEConfig(**TRAIN_SECTIONS["PAE"])
    cpu = PAETrainer(cfg, device="cpu")
    card = PAETrainer(cfg, device=dev)
    cpu.load_state_dict(latest)
    card.load_state_dict(restore_checkpoint(out, "latest"))
    ds = WindowedDataset.load(p("train"))
    x8 = torch.from_numpy(next(iter(ds.batches(8, seed=3))))
    loss_cpu = cpu.train_step(x8)
    loss_card = card.train_step(x8.to(dev))
    fed = {"conv1.bias", "conv2.bias", "deconv1.bias"} | {
        f"fc.{i}.bias" for i in range(cfg.phase_channels)}
    errs = (abs(float(loss_card) - float(loss_cpu)) / float(loss_cpu),
            grad_err(card.model, cpu.model, fed),
            bn_stats_err(card.model, cpu.model))
    log(f"phase 17 PAE step card vs CPU port (batch 8, from latest.pt): "
        f"loss rel {errs[0]:.3e} (tol {TRAIN_LOSS_RTOL}), gradients "
        f"{errs[1][0]:.3e} (tol {TRAIN_GRAD_RTOL}; largest element "
        f"{errs[1][1]:.3e} of its tensor's max; the biases feeding a "
        f"BatchNorm, gradient 0, against the model's max), BatchNorm "
        f"statistics {errs[2]:.3e} (tol {PAE_STATS_RTOL} of each "
        f"tensor's max)")
    if errs[0] > TRAIN_LOSS_RTOL or errs[1][0] > TRAIN_GRAD_RTOL or \
            errs[2] > PAE_STATS_RTOL:
        raise SystemExit("PAE training step: card differs from CPU")
    x32 = torch.from_numpy(next(iter(ds.batches(32, seed=4)))).to(dev)
    time_trainer("PAE (135 x 240 -> 8 phases, batch 32)",
                 lambda: card.train_step(x32), 32)
    return load_pae_checkpoint(os.path.join(out, "latest.pt"), cfg,
                               device=dev)


def phase17_end2end(dev, rng, tmp: str, vq_out: str):
    """train-end2end at hidden 200 and 512 codes on 64 000-sample windows
    whose targets are the trained VQ-VAE's codes, generate --model end2end
    from both output directories against the CPU port, one step card
    against CPU at dropout 0, the step's time at batch 32."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.cli import _end2end_windows
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.config import End2EndConfig, VQVAEConfig
    from qpgesture_tpu_torch.models.convert import (
        load_generator_gru_checkpoint, load_vqvae_checkpoint)
    from qpgesture_tpu_torch.pipelines.audio_prep import write_wav
    from qpgesture_tpu_torch.train.checkpoints import restore_checkpoint
    from qpgesture_tpu_torch.train.data import WindowedDataset
    from qpgesture_tpu_torch.train.train_end2end import End2EndTrainer
    from qpgesture_tpu_torch.utils.metrics_log import ScalarHistory
    p = lambda *names: os.path.join(tmp, *names)

    ds = WindowedDataset.load(p("train"))
    poses = np.asarray(ds.poses[:E2E_WINDOWS])
    vq = load_vqvae_checkpoint(vq_out, VQVAEConfig(
        **TRAIN_SECTIONS["VQVAE"]), device=dev)
    norm = (poses - ds.data_mean) / np.clip(ds.data_std, 0.01, None)
    codes = vq.encode(torch.as_tensor(norm.astype(np.float32), device=dev)
                      ).cpu().numpy().astype(np.int32)
    audio = np.stack([speech_like(rng, 4.0) for _ in range(E2E_WINDOWS)])
    WindowedDataset(poses=poses, audio=audio, codes=codes).save(p("e2e"))
    out = p("gru")
    t0 = time.time()
    cli(["train-end2end", "--config", p("train.yml"), "--data", p("e2e"),
         "--out", out, "--epochs", str(E2E_EPOCHS), "--device", str(dev)])
    losses = [v for _, _, v in ScalarHistory.read(
        os.path.join(out, "scalars.jsonl"))["loss"]]
    latest = restore_checkpoint(out, "latest")
    log(f"phase 17 train-end2end: {E2E_EPOCHS} epochs "
        f"{time.time() - t0:.1f} s ({E2E_WINDOWS} windows with the trained "
        f"VQ-VAE's codes, {len(np.unique(codes))} distinct; batch 32, "
        f"{latest['step']} steps; CLI wall); last-step loss by epoch "
        f"{[round(v, 4) for v in losses]}")
    if not (losses[-1] < losses[0] and np.isfinite(losses).all()):
        raise SystemExit("train-end2end: the loss did not fall")

    speech = speech_like(rng, 20.0)
    write_wav(p("speech20.wav"), speech, 16000)
    cli(["generate", "--wav", p("speech20.wav"), "--model", "end2end",
         "--end2end-checkpoint", out, "--vqvae-checkpoint", vq_out,
         "--config", p("train.yml"), "--pipeline", p("pipeline.json"),
         "--out", p("gen"), "--prefix", "t", "--device", str(dev)])
    got = np.load(p("gen", "code_t.npy"))
    gru_cpu = load_generator_gru_checkpoint(out, device="cpu")
    wins = _end2end_windows(load_wav(p("speech20.wav")))
    with torch.no_grad():
        logits = gru_cpu(torch.from_numpy(wins))
    want = logits.argmax(-1).numpy()
    if got.shape != want.shape:
        raise SystemExit(f"end2end codes {got.shape} vs {want.shape}")
    for w, s in np.argwhere(got != want):
        top = torch.topk(logits[w, s], 2).values
        if float(top[0] - top[1]) > 1e-6 * float(top[0].abs()):
            raise SystemExit("end2end codes differ beyond float32 rounding")
    log(f"phase 17 generate --model end2end from the trained directories: "
        f"codes {got.shape}, {int((got == want).sum())}/{got.size} equal to "
        f"the CPU port's")

    cfg = End2EndConfig(**TRAIN_SECTIONS["end2end"])
    cpu = End2EndTrainer(cfg, device="cpu")
    cpu.model.dropout = 0.0
    card = End2EndTrainer(cfg, device=dev)
    card.model.dropout = 0.0
    cpu.load_state_dict(latest)
    card.load_state_dict(restore_checkpoint(out, "latest"))
    wav8, codes8 = torch.from_numpy(audio[:8]), torch.from_numpy(codes[:8])
    loss_cpu = cpu.train_step(wav8, codes8)
    loss_card = card.train_step(wav8.to(dev), codes8.to(dev))
    fed = {f"WavEncoder.feat_extractor.{k}.bias" for k in (0, 3, 6, 9)}
    errs = (abs(float(loss_card) - float(loss_cpu)) / float(loss_cpu),
            grad_err(card.model, cpu.model, fed),
            bn_stats_err(card.model, cpu.model))
    log(f"phase 17 GeneratorGRU step card vs CPU port (batch 8, dropout 0, "
        f"from latest.pt): loss rel {errs[0]:.3e} (tol {TRAIN_LOSS_RTOL}), "
        f"gradients {errs[1][0]:.3e} (tol {TRAIN_GRAD_RTOL}; largest element "
        f"{errs[1][1]:.3e} of its tensor's max), BatchNorm statistics "
        f"{errs[2]:.3e} (tol {TRAIN_STATS_RTOL} of each tensor's max)")
    if errs[0] > TRAIN_LOSS_RTOL or errs[1][0] > TRAIN_GRAD_RTOL or \
            errs[2] > TRAIN_STATS_RTOL:
        raise SystemExit("GRU training step: card differs from CPU")
    trainer = End2EndTrainer(cfg, device=dev)          # dropout 0.1
    trainer.load_state_dict(restore_checkpoint(out, "latest"))
    w32 = torch.from_numpy(audio[:32]).to(dev)
    c32 = torch.from_numpy(codes[:32]).to(dev)
    time_trainer("GeneratorGRU (hidden 200, 512 codes, batch 32 x 64000 "
                 "samples)", lambda: trainer.train_step(w32, c32), 32)


def phase17_serve(dev, built, vq_out: str, pae_card):
    """Phase 15's train split rebuilt with the trained models: windows
    re-encoded by the trained VQ-VAE, phases from the trained PAE through
    PhaseExtractor, the trained codebook's signature; one wavvq request
    served through K1 and decoded by the trained VQ-VAE, against the CPU
    port's engine on the same database."""
    import dataclasses as dc

    import numpy as np
    from qpgesture_tpu_torch.core.config import MATCH_PRESETS, VQVAEConfig
    from qpgesture_tpu_torch.match.database import (stage_database,
                                                    stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.match.engine import CodeKNNEngine
    from qpgesture_tpu_torch.models.convert import load_vqvae_checkpoint
    from qpgesture_tpu_torch.models.pae import PhaseExtractor
    from qpgesture_tpu_torch.models.vqvae import codebook_signature
    from qpgesture_tpu_torch.core.schemas import CodebookSignature
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.pipelines import database_builder as builder
    from qpgesture_tpu_torch.serve import RawWavServer, ServingPipeline

    mean, std = built["mean"], built["std"]
    vq_cfg = VQVAEConfig(**TRAIN_SECTIONS["VQVAE"])
    vq_card = load_vqvae_checkpoint(vq_out, vq_cfg, device=dev)
    vq_cpu = load_vqvae_checkpoint(vq_out, vq_cfg, device="cpu")
    extractor = PhaseExtractor(pae_card, device=dev)
    train_recs = [dc.replace(r, phase=extractor.pose_to_phase(
        r.rotation, mean, std)) for r in built["recs"]
        if builder.split_of(r.name) == "train"]
    phased = builder.window_recordings(train_recs)
    train = dc.replace(built["bundles"]["train"], phase=phased.phase)
    codes = builder.encode_windows(vq_card, train.body, mean, std)
    norm = (train.body - mean) / np.clip(std, 0.01, None)
    check_codes("phase 17 trained encode_windows train", vq_card, norm,
                codes, builder.encode_windows(vq_cpu, train.body, mean, std))
    code, poses, sig = codebook_signature(vq_card, mean, std)
    signature = CodebookSignature(code=code, poses=poses, signature=sig)
    cfg = dc.replace(MATCH_PRESETS["wavvq"], codebook_size=sig.shape[0])
    db = stage_database(cfg, train, codes, signature,
                        wavvq=built["wavvq"]["train"])
    test = built["bundles"]["test"]
    wav, ctx = test.wav[:W], test.context[:W]
    server = RawWavServer(CodeKNNEngine(cfg, db, device=dev), vq_card,
                          built["wavvq_gpu"], mean, std)
    before = K1.launches
    got, poses = server.serve(wav, ctx, init_code=0,
                              rng=np.random.RandomState(cfg.seed))
    n1 = K1.launches - before
    enc = server.encode(wav).cpu().numpy()
    want, want_poses = ServingPipeline(
        CodeKNNEngine(cfg, db, device="cpu"), vq_cpu, mean, std).serve(
        stage_test_audio(cfg, db, wavvq=enc), stage_test_context(db, ctx),
        init_code=0, rng=np.random.RandomState(cfg.seed))
    pose_err = float(np.abs(poses - want_poses).max())
    log(f"phase 17 served the rebuilt database (wavvq, J={len(train.body)} "
        f"train windows: trained VQ-VAE codes, trained PAE phases "
        f"{phased.phase.shape}, trained signature) for the test split's "
        f"first {W} windows: K1 launches {n1}; codes == the CPU port's "
        f"engine {np.array_equal(got, want)}; decoded by the trained VQ-VAE "
        f"{poses.shape}, card vs CPU {pose_err:.3e} (tol {POSE_ATOL}); "
        f"distinct codes {len(np.unique(got))}")
    if n1 < 1 or got.shape != (W, 30) or not np.array_equal(got, want) or \
            not np.isfinite(poses).all() or pose_err > POSE_ATOL:
        raise SystemExit("phase 17: serving the trained database failed")
    return n1


# -- phase 18: resync training, evaluation, raw-pose search ---------------

def phase18_rawpose(dev, rng, built, tmp: str):
    """Raw-pose GestureKNN: a staged database of RAWPOSE_K seeded synthetic
    sequences x 240 frames (tests/fixtures.py's shapes: 14 MFCC channels,
    13 searched; body 135), search_motion_batch over RAWPOSE_C test
    sequences against solo search_motion on the card and the CPU port
    (RAWPOSE_CPU_LANES of the lanes), times, idle share, resident bytes;
    then warmup --rawpose-batch through the CLI on phase 15's train
    database, whose files (p18_*.npz in tmp) phase18_serve reads too."""
    import contextlib
    import io

    import numpy as np
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.schemas import save_codes, save_wavvq
    from qpgesture_tpu_torch.match.gesture_knn import (
        GestureKNNEngine, normalize_gesture_knn, stage_gesture_knn)
    from qpgesture_tpu_torch.models.vqvae import codebook_signature
    from qpgesture_tpu_torch.core.schemas import CodebookSignature
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1

    t0 = time.perf_counter()
    mfcc = rng.randn(RAWPOSE_K, 240, 14).astype(np.float32)
    body = rng.randn(RAWPOSE_K, 240, 135).astype(np.float32)
    db, test = normalize_gesture_knn(
        stage_gesture_knn(mfcc, body),
        rng.randn(RAWPOSE_C, 240, 14).astype(np.float32))
    stage_s = time.perf_counter() - t0
    seqs = rng.randint(0, RAWPOSE_K, RAWPOSE_C)
    frms = rng.randint(0, 240 - 8, RAWPOSE_C)
    ks = rng.randint(0, 3, RAWPOSE_C)
    engine = GestureKNNEngine(db, device=dev)

    def batch():
        return engine.search_motion_batch(test, seqs, frms, ks)

    got = batch()
    n_steps = int(np.ceil((240 - 1) / db.step_sz))
    batch_ms = median_ms(batch, 5, warmup=1)
    lanes = sorted({0, RAWPOSE_C - 1})[:RAWPOSE_CPU_LANES]
    t0 = time.perf_counter()
    want = GestureKNNEngine(db, device="cpu").search_motion_batch(
        test[lanes], seqs[lanes], frms[lanes], ks[lanes])
    cpu_s = time.perf_counter() - t0
    solo = [engine.search_motion(test[c], int(seqs[c]), int(frms[c]),
                                 int(ks[c])) for c in range(RAWPOSE_C)]
    same_solo = all(np.array_equal(got[c], solo[c])
                    for c in range(RAWPOSE_C))
    same_cpu = np.array_equal(got[lanes], want)
    log(f"phase 18 raw-pose GestureKNN: K={RAWPOSE_K} x 240 frames "
        f"(features {db.feat.shape[-1]} = {db.n_aud} audio + "
        f"{db.feat.shape[-1] - db.n_aud} pose), C={RAWPOSE_C} lanes of 240 "
        f"frames ({n_steps} steps): batch_ms={batch_ms:.3f} "
        f"({batch_ms / n_steps:.4f} ms a step; host clock, host arrays "
        f"out); resident {engine.resident_bytes / 2 ** 20:.1f} MiB; lanes "
        f"== solo search_motion on the card {same_solo}; lanes {lanes} == "
        f"the CPU port {same_cpu} (CPU {cpu_s:.1f} s); staging "
        f"{stage_s:.2f} s")
    if got.shape != (RAWPOSE_C, 135, 240) or not same_solo or not same_cpu:
        raise SystemExit("raw-pose search: lanes differ from solo calls or "
                         "from the CPU port")
    log_profile("phase 18 search_motion_batch", batch)

    # -- warmup --rawpose-batch through the CLI on phase 15's database -----
    p = lambda name: os.path.join(tmp, name)
    train = built["bundles"]["train"]
    train.save(p("p18_db.npz"))
    save_codes(p("p18_codes.npz"), built["codes"]["train"])
    code, poses, sig = codebook_signature(built["vq_gpu"], built["mean"],
                                          built["std"])
    CodebookSignature(code=code, poses=poses, signature=sig).save(
        p("p18_sig.npz"))
    save_wavvq(p("p18_wavvq.npz"), built["wavvq"]["train"])
    buf = io.StringIO()
    before = K1.launches
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        cli(["warmup", "--train-database", p("p18_db.npz"),
             "--train-codebook", p("p18_codes.npz"),
             "--codebook-signature", p("p18_sig.npz"),
             "--train-wavvq", p("p18_wavvq.npz"), "--preset", "wavvq",
             "--buckets", "1", "--rawpose-batch", str(RAWPOSE_C),
             "--device", str(dev)])
    n1 = K1.launches - before
    lines = buf.getvalue().splitlines()
    log(f"phase 18 warmup --rawpose-batch {RAWPOSE_C} (J={len(train.body)}"
        f" database): {time.time() - t0:.1f} s; K1 launches {n1}; "
        f"{[ln for ln in lines if ln.startswith('raw-pose')]}")
    if not lines or not lines[-1].endswith(f"raw-pose batch {RAWPOSE_C}"):
        raise SystemExit("warmup --rawpose-batch did not run")


def phase18_resync_data(built, tmp: str):
    """ResyncNet's training pairs from phase 15's train split, on the host
    as in the JAX package: fake motion by the stochastic-k audio-only
    search (fake_training_pairs) over the split's own raw-pose database,
    RESYNC_REPEATS draws per window; knn = mfcc | fake motion, real =
    mfcc | ground-truth body, z-normalized with the split's resync stats.
    Writes the --data npz; returns its path and the fake motion (N, 135,
    240)."""
    import numpy as np
    from qpgesture_tpu_torch.match.gesture_knn import (
        fake_training_pairs, normalize_gesture_knn, stage_gesture_knn)
    from qpgesture_tpu_torch.models.resync import resync_stats

    train = built["bundles"]["train"]
    t0 = time.perf_counter()
    db, feats = normalize_gesture_knn(
        stage_gesture_knn(train.mfcc, train.body), train.mfcc)
    feats = np.tile(feats, (RESYNC_REPEATS, 1, 1))
    fake = fake_training_pairs(db, feats, np.random.RandomState(SEED))
    host_ms = 1e3 * (time.perf_counter() - t0)
    mfcc = np.tile(train.mfcc[:, :, :13], (RESYNC_REPEATS, 1, 1))
    body = np.tile(train.body, (RESYNC_REPEATS, 1, 1))
    mm, ms, gm, gs = resync_stats(train.mfcc[:, :, :13], train.body)
    eps = np.float32(1e-8)
    mfcc_n = (mfcc - mm) / (ms + eps)
    knn = np.concatenate([mfcc_n, (fake.transpose(0, 2, 1) - gm) / (gs + eps)],
                         -1).astype(np.float32)
    real = np.concatenate([mfcc_n, (body - gm) / (gs + eps)], -1).astype(
        np.float32)
    path = os.path.join(tmp, "resync_pairs.npz")
    np.savez(path, knn=knn, real=real)
    log(f"phase 18 resync training data: fake_training_pairs over phase 15's"
        f" J={len(train.body)} train windows x {RESYNC_REPEATS} draws -> "
        f"knn/real {knn.shape}; host_ms={host_ms:.1f}")
    if knn.shape[0] < RESYNC_BATCH or not np.isfinite(knn).all():
        raise SystemExit("resync training data: too few or non-finite pairs")
    return path, fake


def resync_flops(trainer, knn, real, eps) -> tuple:
    """(D step, G step) floating-point operations of the trainer's
    convolutions and products, counted over one step of each (forward,
    backward and the penalty's double backward) by utils/devtime's
    dispatch mode over torch's flop formulas (FlopCounterMode's module
    hooks refuse the penalty's autograd.grad on a leaf input). The counted
    steps update the weights: the caller passes a trainer of its own."""
    from qpgesture_tpu_torch.utils.devtime import cost_analysis_flops
    return (cost_analysis_flops(lambda: trainer.d_step(knn, real, eps))[0],
            cost_analysis_flops(lambda: trainer.g_step(knn, real))[0])


def resync_float64_grads(trainer, x_knn, x_real, eps):
    """The gradients of one critic step and one generator step computed in
    float64 on the CPU from ``trainer``'s current weights (before its own
    steps). Returns (a function of the critic the generator step scores
    against (the float32 trainer's updated one) giving (critic module,
    generator module) copies whose ``.grad`` hold the float64 gradients,
    the critic loss's parts [mean D(fake), mean D(real), lambda *
    penalty])."""
    import copy as copy_

    import torch
    import torch.nn.functional as F
    from qpgesture_tpu_torch.models.resync import gradient_penalty

    cfg, n_mfcc = trainer.cfg, trainer.n_mfcc
    gen = copy_.deepcopy(trainer.gen).double().train()
    disc = copy_.deepcopy(trainer.disc).double()
    knn = x_knn.double().transpose(1, 2)
    real = x_real.double().transpose(1, 2)
    with torch.no_grad():
        fake = torch.cat((knn[:, :n_mfcc], gen(knn)), 1)
    parts = [disc(fake).mean(), disc(real).mean(), cfg.lambda_gp *
             gradient_penalty(disc, real, fake, eps.double())]
    (parts[0] - parts[1] + parts[2]).backward()

    def generator_step(updated_disc):
        critic = copy_.deepcopy(updated_disc).double()
        motion = gen(knn)
        loss = cfg.weight_gen * -critic(torch.cat(
            (knn[:, :n_mfcc], motion), 1)).mean() + \
            cfg.weight_recon * F.l1_loss(motion, knn[:, n_mfcc:])
        gen.zero_grad()
        loss.backward()
        return disc, gen

    return generator_step, [float(p.detach()) for p in parts]


def time_resync(iters):
    """({"D": ms, "D+G": ms} per iteration from CUDA events around
    RESYNC_TIMED iterations of each kind, peak memory in GiB). ``iters``
    runs the iterations it is given."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    for name, its in (("D", [1, 2, 3, 4] * (RESYNC_TIMED // 4)),
                      ("D+G", [0] * RESYNC_TIMED)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        iters(its)
        end.record()
        end.synchronize()
        times[name] = start.elapsed_time(end) / len(its)
    return times, torch.cuda.max_memory_allocated() / 2 ** 30


def phase18_train_resync(dev, data: str, tmp: str):
    """train-resync through the CLI at full width (ResyncConfig: batch 100,
    lambda 100, gen_hop 5) for RESYNC_ITERS iterations; one critic and one
    generator step card against CPU from the written latest.pt at batch
    RESYNC_CHECK_BATCH with the same eps; an iteration under sync debug
    "error"; D-only and D + G iteration times, TFLOP/s against the counted
    operations, idle share, peak memory. Returns the output directory."""
    import contextlib
    import io

    import numpy as np
    import torch
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.config import ResyncConfig
    from qpgesture_tpu_torch.train.checkpoints import restore_checkpoint
    from qpgesture_tpu_torch.train.train_resync import ResyncTrainer

    out = os.path.join(tmp, "resync")
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        cli(["train-resync", "--data", data, "--iters", str(RESYNC_ITERS),
             "--batch-size", str(RESYNC_BATCH), "--out", out,
             "--device", str(dev)])
    wall = time.time() - t0
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("iter")]
    state = restore_checkpoint(out, "latest")
    log(f"phase 18 train-resync: {RESYNC_ITERS} iterations at batch "
        f"{RESYNC_BATCH} {wall:.1f} s (CLI wall); critic steps "
        f"{state['step']}; {lines[0]} ... {lines[-1]}")
    losses = [float(v) for ln in lines for v in ln.split()[3::2]]
    if state["step"] != RESYNC_ITERS or not np.isfinite(losses).all():
        raise SystemExit("train-resync: wrong step count or non-finite loss")

    # -- one iteration, card against CPU, from latest.pt ---------------------
    pairs = np.load(data)
    knn, real = pairs["knn"], pairs["real"]
    n, t, c = knn.shape
    cfg = ResyncConfig(gen_hop=1)

    def trainer(device):
        tr = ResyncTrainer(cfg, n_mfcc=c - 135, n_joints=135, num_frames=t,
                           device=device)
        tr.load_state_dict(restore_checkpoint(out, "latest"))
        return tr

    cpu, card = trainer("cpu"), trainer(dev)
    fed = lambda m: {nm for nm, _ in m.named_parameters()  # noqa: E731
                     if nm.endswith((".0.bias", ".3.bias"))}
    b = RESYNC_CHECK_BATCH
    xk, xr = torch.from_numpy(knn[:b]), torch.from_numpy(real[:b])
    eps = torch.rand((b, 1, 1), generator=torch.Generator().manual_seed(SEED))
    ref, f64_parts = resync_float64_grads(cpu, xk, xr, eps)
    # the critic loss's parts (scores, lambda * penalty) on each side, from
    # copies of the weights before the steps
    parts = {side: critic_terms(copy.deepcopy(tr.gen), copy.deepcopy(tr.disc),
                                *(x.to(tr.device) for x in (xk, xr, eps)),
                                cfg.lambda_gp, n_mfcc=c - 135)
             for side, tr in (("card", card), ("cpu", cpu))}
    parts["f64"] = f64_parts
    want = {"d_loss": cpu.d_step(xk, xr, eps)}
    got = {"d_loss": card.d_step(xk.to(dev), xr.to(dev), eps.to(dev))}
    d_grad = grad_err(card.disc, cpu.disc, fed(cpu.disc))
    # the generator step against the same critic: Adam (b1 = 0) moves each
    # weight by about lr times its gradient's sign, so the weights whose
    # gradient is rounding noise leave the two critics ~lr apart
    card.disc.load_state_dict(cpu.disc.state_dict())
    want["g_loss"] = cpu.g_step(xk, xr)
    got["g_loss"] = card.g_step(xk.to(dev), xr.to(dev))
    ref_g = ref(cpu.disc)
    errs = {k: loss_gap(float(got[k]), float(want[k])) for k in want}
    d_scale = max(abs(float(want["d_loss"])), 1.0)
    score = lambda t: t[0] - t[1]       # noqa: E731
    score_err = abs(score(parts["card"]) - score(parts["cpu"])) / d_scale
    pen_err = abs(parts["card"][2] - parts["cpu"][2]) / abs(parts["cpu"][2])
    # d_loss = scores + penalty: each part's tolerance, as a share of d_loss
    d_tol = TRAIN_LOSS_RTOL + RESYNC_PENALTY_RTOL * abs(parts["cpu"][2]) / \
        d_scale
    d_f64 = score(parts["f64"]) + parts["f64"][2]
    g_grad = grad_err(card.gen, cpu.gen, fed(cpu.gen))
    f64 = {name: [grad_err(m, r, fed(r))[0] for m in (card_m, cpu_m)]
           for name, card_m, cpu_m, r in (
               ("critic", card.disc, cpu.disc, ref_g[0]),
               ("generator", card.gen, cpu.gen, ref_g[1]))}
    stats = bn_stats_err(card.gen, cpu.gen)
    log(f"phase 18 resync iteration card vs CPU port (batch {b}, from "
        f"latest.pt, the same eps, the generator step against the CPU's "
        f"updated critic): critic scores rel {score_err:.3e} (tol "
        f"{TRAIN_LOSS_RTOL}), penalty term {parts['card'][2]:.7f} / "
        f"{parts['cpu'][2]:.7f} rel {pen_err:.3e} of itself (tol "
        f"{RESYNC_PENALTY_RTOL}), d_loss rel {errs['d_loss']:.3e} (tol "
        f"{d_tol:.3e}, the parts' sum), against float64 card "
        f"{loss_gap(float(got['d_loss']), d_f64):.3e} / CPU float32 "
        f"{loss_gap(float(want['d_loss']), d_f64):.3e}; g_loss "
        f"rel {errs['g_loss']:.3e} (tol {TRAIN_LOSS_RTOL}); gradients critic "
        f"{d_grad[0]:.3e}, generator {g_grad[0]:.3e} (tol "
        f"{RESYNC_GRAD_RTOL}, per tensor; the norm-fed conv biases against "
        f"the model's max); against the float64 CPU reference: critic card "
        f"{f64['critic'][0]:.3e} / CPU float32 {f64['critic'][1]:.3e}, "
        f"generator card {f64['generator'][0]:.3e} / CPU float32 "
        f"{f64['generator'][1]:.3e}; BatchNorm statistics {stats:.3e} (tol "
        f"{TRAIN_STATS_RTOL})")
    if errs["g_loss"] > TRAIN_LOSS_RTOL or score_err > TRAIN_LOSS_RTOL or \
            pen_err > RESYNC_PENALTY_RTOL or errs["d_loss"] > d_tol or \
            max(d_grad[0], g_grad[0]) > RESYNC_GRAD_RTOL or \
            stats > TRAIN_STATS_RTOL:
        raise SystemExit("resync iteration: card differs from CPU")
    del cpu

    # -- times at the configuration's batch ---------------------------------
    B = RESYNC_BATCH
    kd = torch.from_numpy(knn[:B]).to(dev)
    rd = torch.from_numpy(real[:B]).to(dev)
    d_flops, g_flops = resync_flops(trainer(dev), kd, rd,
                                    torch.rand((B, 1, 1), device=dev))
    timed = trainer(dev)
    timed.cfg = ResyncConfig()                      # gen_hop 5

    def iters(its):
        for it in its:
            timed.train_iteration(kd, rd, it)

    iters(range(6))
    step_without_sync(lambda: timed.train_iteration(kd, rd, 5))
    times, peak = time_resync(iters)
    d_tf = d_flops / times["D"] / 1e9
    dg_tf = (d_flops + g_flops) / times["D+G"] / 1e9
    log(f"phase 18 resync iteration times (batch {B}, CUDA events over "
        f"{RESYNC_TIMED}): D only {times['D']:.3f} ms, D + G "
        f"{times['D+G']:.3f} ms; counted operations (torch's flop formulas) "
        f"{d_flops / 1e12:.4f} TFLOP a D step, {g_flops / 1e12:.4f} a G "
        f"step: {d_tf:.2f} / {dg_tf:.2f} TFLOP/s "
        f"({100 * d_tf * 1e12 / F32_FLOPS:.0f} / "
        f"{100 * dg_tf * 1e12 / F32_FLOPS:.0f} % of the f32 peak); peak "
        f"max_memory_allocated {peak:.3f} GiB; one iteration under sync "
        f"debug \"error\" ok")

    def five():
        iters(range(5))
        torch.cuda.synchronize()

    log_profile("phase 18 resync 5 iterations (one D + G)", five)
    return out


def critic_terms(gen, disc, knn, real, eps, lambda_gp, n_mfcc=13):
    """(mean D(fake), mean D(real), lambda * penalty) of the critic's loss
    at (B, T, C) inputs, without a step; gen in training mode."""
    import torch
    from qpgesture_tpu_torch.models.resync import gradient_penalty
    knn, real = knn.transpose(1, 2), real.transpose(1, 2)
    gen.train()
    with torch.no_grad():
        fake = torch.cat((knn[:, :n_mfcc], gen(knn)), 1)
    return [float(disc(fake).mean().detach()),
            float(disc(real).mean().detach()),
            float(lambda_gp * gradient_penalty(disc, real, fake,
                                               eps).detach())]

def loss_gap(got: float, want: float) -> float:
    """Phase 18's loss gate: the difference relative to max(|want|, 1)."""
    return abs(got - want) / max(abs(want), 1.0)


def phase18_serve(dev, built, tmp: str, resync_dir: str, fake):
    """generate --preset wavvq --resync <train-resync dir> on phase 15's
    database (K1) and resync-apply --checkpoint <dir>, each against the
    CPU port: codes equal to the CPU port's engine over the card's staged
    vq-wav2vec codes, the resync transform and resync-apply within 1e-3 x
    the motion std, the CLI's BVH that motion. Returns the resynced
    poses."""
    import argparse

    import numpy as np
    import torch
    import yaml
    from qpgesture_tpu_torch.cli import _make_resync_transform, _match_codes
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.config import MATCH_PRESETS, load_config
    from qpgesture_tpu_torch.core.schemas import CodebookSignature
    from qpgesture_tpu_torch.match.database import (stage_database,
                                                    stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.match.engine import CodeKNNEngine
    from qpgesture_tpu_torch.models.vq_wav2vec import \
        load_vq_wav2vec_checkpoint
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.pipelines import database_builder as builder
    from qpgesture_tpu_torch.pipelines.audio_prep import write_wav
    from qpgesture_tpu_torch.render.decode import decode_codes

    p = lambda name: os.path.join(tmp, name)
    torch.save({"model": built["wavvq_cpu"].state_dict()}, p("p18_wavvq.pt"))
    torch.save({"model_dict": built["vq_cpu"].state_dict()},
               p("p18_vqvae.bin"))
    with open(p("p18_config.yml"), "w") as f:
        yaml.safe_dump({"data_mean": built["mean"].tolist(),
                        "data_std": built["std"].tolist()}, f)
    with open(p("p18_pipeline.json"), "w") as f:
        f.write(built["pipeline"].to_json())
    test_rec = next(r for r in built["recs"]
                    if builder.split_of(r.name) == "test")
    wav = test_rec.wav[:W * 4 * 16000].astype(np.float32)
    write_wav(p("p18_speech.wav"), wav, 16000)
    wav = load_wav(p("p18_speech.wav"))
    files = ["--train-database", p("p18_db.npz"),
             "--train-codebook", p("p18_codes.npz"),
             "--codebook-signature", p("p18_sig.npz"),
             "--train-wavvq", p("p18_wavvq.npz")]
    before = K1.launches
    t0 = time.time()
    cli(["generate", "--wav", p("p18_speech.wav"), *files,
         "--wavvq-checkpoint", p("p18_wavvq.pt"),
         "--vqvae-checkpoint", p("p18_vqvae.bin"),
         "--pipeline", p("p18_pipeline.json"), "--config",
         p("p18_config.yml"), "--preset", "wavvq", "--resync", resync_dir,
         "--out", p("p18_gen"), "--prefix", "r", "--device", str(dev)])
    gen_s = time.time() - t0
    bvh = parse_bvh(p(os.path.join("p18_gen", "r_generated.bvh")))

    ns = argparse.Namespace(**{k[2:].replace("-", "_"): v for k, v in
                               zip(files[::2], files[1::2])},
                            train_wavlm=None, preset="wavvq",
                            wavvq_checkpoint=p("p18_wavvq.pt"),
                            device=str(dev))
    codes, bundle = _match_codes(ns, wav)
    n1 = K1.launches - before
    cfg = MATCH_PRESETS["wavvq"]
    sig = CodebookSignature.load(p("p18_sig.npz"))
    cfg = dataclasses.replace(cfg, codebook_size=sig.signature.shape[0])
    db = stage_database(cfg, bundle, built["codes"]["train"], sig,
                        wavvq=built["wavvq"]["train"])
    windows = builder.window_test_audio(wav)
    enc = builder.extract_wavvq(load_vq_wav2vec_checkpoint(
        p("p18_wavvq.pt"), device=dev), windows)
    # no transcript: the empty-text embedding per window, as generate does
    ctx = np.tile(builder.hashed_embed_fn()([""] * 30)[None],
                  (windows.shape[0], 1, 1)).astype(np.float32)
    want = CodeKNNEngine(cfg, db, device="cpu").predict(
        stage_test_audio(cfg, db, wavvq=enc),
        stage_test_context(db, ctx)).codes
    # the stats as the CLI reads them (float64 from the YAML)
    conf = load_config(p("p18_config.yml"))
    poses = decode_codes(built["vq_gpu"], codes, np.asarray(conf.data_mean),
                         np.asarray(conf.data_std))
    resynced = _make_resync_transform(resync_dir, wav, bundle, dev)(poses)
    cpu_resynced = _make_resync_transform(resync_dir, wav, bundle,
                                          torch.device("cpu"))(poses)
    scale = float(cpu_resynced.std())
    err = float(np.abs(resynced - cpu_resynced).max())
    from qpgesture_tpu_torch.render.decode import poses_to_bvh
    bvh_err = float(np.abs(bvh.values - poses_to_bvh(
        resynced, built["pipeline"]).values).max())
    log(f"phase 18 generate --preset wavvq --resync <train-resync dir> "
        f"({W * 4} s of the test recording, phase 15's J={len(bundle.body)}"
        f" database): {gen_s:.1f} s; K1 launches {n1}; codes {codes.shape} "
        f"== the CPU port's engine over the card's staged vq-wav2vec codes "
        f"{np.array_equal(codes, want)}; resync transform card vs CPU port "
        f"max_abs_err {err:.3e} (tol 1e-3 x motion std {scale:.3f}); the "
        f"CLI's BVH vs that motion {bvh_err:.3e}")
    if (dev.type == "cuda" and n1 < 1) or not np.array_equal(codes, want) \
            or err > 1e-3 * scale or \
            bvh_err > 1e-3 or not np.isfinite(resynced).all():
        raise SystemExit("generate --resync from the train-resync directory "
                         "differs from the CPU port")

    # -- resync-apply --checkpoint <dir> -------------------------------------
    N = fake.shape[0] // RESYNC_REPEATS
    np.savez(p("p18_knn.npz"), knn_pred=fake[:N])
    np.savez(p("p18_test.npz"), mfcc=built["bundles"]["train"].mfcc)
    outs = {}
    for d in (str(dev), "cpu"):
        t0 = time.time()
        cli(["resync-apply", "--knn", p("p18_knn.npz"), "--test-data",
             p("p18_test.npz"), "--train-database", p("p18_db.npz"),
             "--checkpoint", resync_dir, "--out", p(f"p18_stage2_{d}.npz"),
             "--device", d])
        outs[d] = (np.load(p(f"p18_stage2_{d}.npz"))["knn_pred"],
                   time.time() - t0)
    scale = float(outs["cpu"][0].std())
    err = float(np.abs(outs[str(dev)][0] - outs["cpu"][0]).max())
    log(f"phase 18 resync-apply --checkpoint <train-resync dir> (N={N} "
        f"fake-motion windows): card vs CPU port max_abs_err {err:.3e} (tol "
        f"1e-3 x motion std {scale:.3f}); CLI {outs[str(dev)][1]:.1f} s "
        f"(card) / {outs['cpu'][1]:.1f} s (cpu)")
    if outs[str(dev)][0].shape != fake[:N].shape or err > 1e-3 * scale:
        raise SystemExit("resync-apply from the train-resync directory "
                         "differs from the CPU port")
    return resynced


def phase18_evaluate(dev, built, tmp: str, vq_out: str, generated):
    """train-fgd on phase 15's ground-truth windows (every split) at the
    CLI's defaults; evaluate of the generated motion against the test
    split's ground truth with the extractor and phase 17's trained VQ-VAE
    on the card and on the CPU: hellinger and fgd_raw bit-equal, the two
    feature-space FGDs within FGD_RTOL."""
    import contextlib
    import io

    import numpy as np
    import yaml
    from qpgesture_tpu_torch.cli import main as cli

    p = lambda name: os.path.join(tmp, name)
    gt_all = np.concatenate([b.body for b in built["bundles"].values()])
    np.savez(p("p18_gt_all.npz"), body=gt_all)
    np.savez(p("p18_gt_test.npz"), body=built["bundles"]["test"].body)
    np.savez(p("p18_generated.npz"), poses=generated)
    with open(p("p18_eval.yml"), "w") as f:
        yaml.safe_dump({**TRAIN_SECTIONS, "data_mean": built["mean"].tolist(),
                        "data_std": built["std"].tolist()}, f)

    def run(argv):
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            cli(argv)
        return buf.getvalue().strip().splitlines(), time.time() - t0

    lines, fgd_s = run(["train-fgd", "--data", p("p18_gt_all.npz"), "--out",
                        p("p18_fgd.ckpt"), "--epochs", str(FGD_EPOCHS),
                        "--device", str(dev)])
    log(f"phase 18 train-fgd ({len(gt_all)} ground-truth windows of 240 x "
        f"135, width 64, latent 32, batch 64, {FGD_EPOCHS} epochs): "
        f"{fgd_s:.1f} s; {lines[-2]}")
    argv = ["evaluate", "--generated", p("p18_generated.npz"), "--reference",
            p("p18_gt_test.npz"), "--fgd-extractor", p("p18_fgd.ckpt"),
            "--vqvae-checkpoint", vq_out, "--config", p("p18_eval.yml")]
    res = {}
    for d in (str(dev), "cpu"):
        lines, secs = run(argv + ["--device", d])
        res[d] = (json.loads(lines[-1]), secs)
    got, want = res[str(dev)][0], res["cpu"][0]
    # relative, past the JSON's rounding to 4 decimals
    rel = {k: max(abs(got[k] - want[k]) - 1e-4, 0.0) / max(abs(want[k]),
                                                           1e-6)
           for k in ("fgd_feature", "fgd_vqvae_latent")}
    log(f"phase 18 evaluate (card): {json.dumps(got)}; CPU port: "
        f"{json.dumps(want)}; hellinger and fgd_raw bit-equal "
        f"{got['hellinger'] == want['hellinger'] and got['fgd_raw'] == want['fgd_raw']}"
        f"; fgd_feature rel {rel['fgd_feature']:.3e}, fgd_vqvae_latent rel "
        f"{rel['fgd_vqvae_latent']:.3e} (tol {FGD_RTOL}); CLI "
        f"{res[str(dev)][1]:.1f} s (card) / {res['cpu'][1]:.1f} s (cpu)")
    if sorted(got) != sorted(want) or got["hellinger"] != want["hellinger"] \
            or got["fgd_raw"] != want["fgd_raw"] or \
            max(rel.values()) > FGD_RTOL or \
            not all(np.isfinite(v) for v in got.values()):
        raise SystemExit("evaluate on the card differs from the CPU port")
    # the parts, timed alone on the same arrays
    from qpgesture_tpu_torch.render.fgd_extractor import (fgd_encoder_fn,
                                                          load_fgd_extractor)
    from qpgesture_tpu_torch.render.metrics import fgd, hellinger_velocity
    ref = built["bundles"]["test"].body
    wg = generated[:(len(generated) // 240) * 240].reshape(-1, 240, 135)
    model, mean, std = load_fgd_extractor(p("p18_fgd.ckpt"), device=dev)
    enc = fgd_encoder_fn(model, mean, std)
    parts = {}
    for name, fn in (
            ("hellinger", lambda: hellinger_velocity(
                generated, ref.reshape(-1, 135))),
            ("fgd_raw", lambda: fgd(wg, ref)),
            ("fgd_feature", lambda: fgd(wg, ref, encoder=enc))):
        t0 = time.perf_counter()
        fn()
        parts[name] = 1e3 * (time.perf_counter() - t0)
    log("phase 18 evaluate parts (host clock, ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))


def phase18_mfcc(dev, built):
    """SphinxMFCC on the card over phase 15's recordings (trimmed to the
    shortest) against the host oracle sphinx_mfcc_np and the CPU port."""
    import numpy as np
    from qpgesture_tpu_torch.ops.mfcc import (MFCCConfig, SphinxMFCC,
                                              sphinx_mfcc_np)
    n = min(len(r.wav) for r in built["recs"])
    sigs = np.stack([r.wav[:n] for r in built["recs"]]).astype(np.float32)
    cfg = MFCCConfig(frate=60)
    card = SphinxMFCC(cfg, device=dev)
    got = card(sigs)
    cpu = SphinxMFCC(cfg, device="cpu")(sigs)
    oracle = np.stack([sphinx_mfcc_np(s.astype(np.float64), cfg)
                       for s in sigs])
    err_cpu = float(np.abs(got - cpu).max())
    err_oracle = float(np.abs(got - oracle).max())
    ms = median_ms(lambda: card(sigs), 5, warmup=1)
    log(f"phase 18 batched MFCC on the card: {sigs.shape} -> {got.shape}; "
        f"vs the CPU port {err_cpu:.3e} (tol {MFCC_ATOL}), vs the float64 "
        f"host oracle {err_oracle:.3e} (tol {MFCC_ORACLE_ATOL}); {ms:.3f} ms "
        f"(host frames in, host array out)")
    if got.shape != oracle.shape or err_cpu > MFCC_ATOL or \
            err_oracle > MFCC_ORACLE_ATOL:
        raise SystemExit("batched MFCC on the card differs")


# -- phase 19: the rest of the single-GPU surface --------------------------

def phase19_vqvae_steps(dev, rng):
    """A training step at the shipped VQVAEConfig and batch P19_BATCH x 240
    at each conv_precision ("highest" beside "default" and "high", the same
    seeded weights), its time, windows/s, idle share, peak memory and share
    of the peak for its operand type (utils/devtime); one step at
    P19_CHECK_BATCH card against the CPU port from the same state at
    "default" and "high"; a step under sync debug "error"."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.core.config import TrainConfig, VQVAEConfig
    from qpgesture_tpu_torch.train.data import DeviceClipStore
    from qpgesture_tpu_torch.train.train_vqvae import VQVAETrainer
    from qpgesture_tpu_torch.utils.devtime import (cost_analysis_flops, mfu,
                                                   peak_flops_per_s)

    clips = training_clips(rng, P19_CLIPS, TRAIN_CLIP_FRAMES)
    flat = np.concatenate([c["poses"] for c in clips])
    store = DeviceClipStore(clips, 240, 32, flat.mean(0), flat.std(0),
                            device=dev)
    x = next(iter(store.batches(P19_BATCH, seed=0)))
    tcfg = TrainConfig(batch_size=P19_BATCH)
    out = {}
    for precision in ("highest", "default", "high"):
        cfg = VQVAEConfig(conv_precision=precision)
        trainer = VQVAETrainer(cfg, tcfg, device=dev, seed=0)
        trainer.init_codebook(x)
        trainer.train_step(x)
        if precision != "highest":
            step_without_sync(lambda: trainer.train_step(x))
        flops = cost_analysis_flops(lambda: trainer.train_step(x))[0]
        ms = time_trainer(f"VQ-VAE conv_precision={precision!r} (batch "
                          f"{P19_BATCH} x 240 frames)",
                          lambda: trainer.train_step(x), P19_BATCH,
                          phase="phase 19")
        dtype = "float32" if precision == "highest" else "bfloat16"
        name, peak = peak_flops_per_s(dtype) if dev.type == "cuda" \
            else ("cpu", 0.0)
        share = mfu(flops, ms / 1e3, peak)
        out[precision] = ms
        log(f"phase 19 VQ-VAE {precision!r}: {flops / 1e12:.4f} TFLOP "
            f"counted a step (bf16x3 counts its three products), "
            f"{flops / ms / 1e9:.2f} TFLOP/s = "
            f"{'n/a' if share is None else f'{100 * share:.1f} %'} of "
            f"{name}'s {dtype} peak ({peak / 1e12:.0f} TFLOP/s, NVIDIA's "
            f"H100 SXM data sheet)")
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    log(f"phase 19 VQ-VAE step ms at batch {P19_BATCH}: highest "
        f"{out['highest']:.3f}, default {out['default']:.3f} (x"
        f"{out['highest'] / out['default']:.2f}), high {out['high']:.3f} "
        f"(x{out['highest'] / out['high']:.2f})")

    # card against CPU from the same state: the codebook drawn on the card
    # from the P19_BATCH windows (more latents than codes)
    xb = x[:P19_CHECK_BATCH].cpu()
    for precision in ("default", "high"):
        cfg = VQVAEConfig(conv_precision=precision)
        tcfg8 = TrainConfig(batch_size=P19_CHECK_BATCH)
        card = VQVAETrainer(cfg, tcfg8, device=dev, seed=1)
        card.init_codebook(x)
        cpu = VQVAETrainer(cfg, tcfg8, device="cpu", seed=1)
        cpu.load_state_dict(card.state_dict())
        default = precision == "default"
        check_codes(f"phase 19 VQ-VAE {precision!r} step batch", card.model,
                    xb.numpy(), card.model.encode(xb.to(dev)).cpu().numpy(),
                    cpu.model.encode(xb).numpy(),
                    DEFAULT_CODE_GAP_RTOL if default else CODE_GAP_RTOL)
        t0 = time.time()
        loss_cpu, _ = cpu.train_step(xb)
        t_cpu = time.time() - t0
        loss_card, _ = card.train_step(xb.to(dev))
        loss_err = abs(float(loss_card) - float(loss_cpu)) / float(loss_cpu)
        g_err = grad_err(card.model, cpu.model)
        loss_tol = DEFAULT_LOSS_RTOL if default else TRAIN_LOSS_RTOL
        grad_tol = DEFAULT_GRAD_RTOL if default else TRAIN_GRAD_RTOL
        log(f"phase 19 VQ-VAE {precision!r} step card vs CPU port (full "
            f"width, batch {P19_CHECK_BATCH}): loss rel {loss_err:.3e} (tol "
            f"{loss_tol}), gradients {g_err[0]:.3e} (tol {grad_tol}; largest "
            f"element {g_err[1]:.3e}); CPU step {t_cpu:.1f} s")
        if loss_err > loss_tol or g_err[0] > grad_tol:
            raise SystemExit(f"VQ-VAE {precision!r} step: card differs from "
                             "CPU")
        del cpu, card
    return out


def phase19_vqvae_serve(dev, built, tmp: str):
    """Phase 15's VQ-VAE at each conv_precision: encode of phase 15's
    windows (code agreement with "highest", reported), the "default" codes
    against the CPU port's "default"; a wavvq request staged from phase
    15's test split, served through K1 from the train split's "default"
    codes and signature, against the CPU port; levels=2 encode / decode;
    the "default" model through a flax-layout .msgpack file and decode
    --checkpoint on the card. Returns the "default" codes and signature."""
    import dataclasses as dc

    import numpy as np
    import torch
    import yaml
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.config import MATCH_PRESETS, VQVAEConfig
    from qpgesture_tpu_torch.core.schemas import CodebookSignature
    from qpgesture_tpu_torch.match.database import (stage_database,
                                                    stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.match.engine import CodeKNNEngine
    from qpgesture_tpu_torch.models.convert import vqvae_state_dict_to_jax
    from qpgesture_tpu_torch.models.vqvae import (VQVAE, codebook_signature,
                                                  load_vqvae_native)
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.pipelines import database_builder as builder
    from qpgesture_tpu_torch.serve import ServingPipeline
    from qpgesture_tpu_torch.utils import flax_msgpack
    p = lambda *names: os.path.join(tmp, *names)

    mean, std = built["mean"], built["std"]
    sd = built["vq_cpu"].state_dict()
    models = {}
    for precision in ("highest", "default", "high"):
        m = VQVAE(VQVAEConfig(conv_precision=precision), device=dev)
        m.load_state_dict(sd)
        models[precision] = m
    bodies = {s: built["bundles"][s].body for s in ("train", "test")}
    allb = np.concatenate([bodies["train"], bodies["test"]])
    codes = {}
    for precision, m in models.items():
        t0 = time.perf_counter()
        codes[precision] = builder.encode_windows(m, allb, mean, std)
        log(f"phase 19 encode_windows {precision!r}: {allb.shape[0]} "
            f"windows in {1e3 * (time.perf_counter() - t0):.1f} ms (host in, "
            f"host out); codes equal to \"highest\"'s "
            f"{(codes[precision] == codes['highest']).mean():.4f} of "
            f"{codes[precision].size}")
    vq_cpu_default = VQVAE(VQVAEConfig(conv_precision="default"),
                           device="cpu")
    vq_cpu_default.load_state_dict(sd)
    norm = (allb - mean) / np.clip(std, 0.01, None)
    check_codes("phase 19 encode_windows 'default'", models["default"], norm,
                codes["default"],
                builder.encode_windows(vq_cpu_default, allb, mean, std),
                DEFAULT_CODE_GAP_RTOL)

    # a wavvq request through K1 from the "default" codes
    n_train = len(bodies["train"])
    code, poses, sig = codebook_signature(models["default"], mean, std)
    signature = CodebookSignature(code=code, poses=poses, signature=sig)
    cfg = dc.replace(MATCH_PRESETS["wavvq"], codebook_size=sig.shape[0])
    db = stage_database(cfg, built["bundles"]["train"],
                        codes["default"][:n_train], signature,
                        wavvq=built["wavvq"]["train"])
    test = built["bundles"]["test"]
    audio = stage_test_audio(cfg, db, wavvq=built["wavvq"]["test"][:W])
    ctx = stage_test_context(db, test.context[:W])
    before = K1.launches
    got, got_poses = ServingPipeline(
        CodeKNNEngine(cfg, db, device=dev), models["default"], mean,
        std).serve(audio, ctx, init_code=0,
                   rng=np.random.RandomState(cfg.seed))
    n1 = K1.launches - before
    want, want_poses = ServingPipeline(
        CodeKNNEngine(cfg, db, device="cpu"), vq_cpu_default, mean,
        std).serve(audio, ctx, init_code=0,
                   rng=np.random.RandomState(cfg.seed))
    pose_err = float(np.abs(got_poses - want_poses).max())
    pose_tol = DEFAULT_POSE_RTOL * float(np.abs(want_poses).max())
    log(f"phase 19 wavvq request on the \"default\" codes (J={n_train}, "
        f"{W} windows): K1 launches {n1}; codes == the CPU port's "
        f"{np.array_equal(got, want)}; \"default\" decode card vs CPU "
        f"{pose_err:.3e} (tol {pose_tol:.3e}: {DEFAULT_POSE_RTOL} of the "
        f"largest pose value)")
    if (dev.type == "cuda" and n1 < 1) or not np.array_equal(got, want) or \
            pose_err > pose_tol or \
            not np.isfinite(got_poses).all():
        raise SystemExit("phase 19: the \"default\" wavvq request failed")

    # levels = 2
    l2 = VQVAEConfig(levels=2, downs_t=(3, 1), strides_t=(2, 2),
                     hvqvae_multipliers=(1, 1))
    torch.manual_seed(SEED)
    l2_cpu = VQVAE(l2, device="cpu")
    l2_cpu.init_codebook_from_batch(torch.as_tensor(
        norm.astype(np.float32)), np.random.RandomState(SEED))
    l2_card = VQVAE(l2, device=dev)
    l2_card.load_state_dict(l2_cpu.state_dict())
    c2 = builder.encode_windows(l2_card, allb, mean, std)
    check_codes("phase 19 levels=2 encode", l2_card, norm, c2,
                builder.encode_windows(l2_cpu, allb, mean, std))
    y2 = l2_card.decode(torch.as_tensor(c2, device=dev)).cpu().numpy()
    y2_err = float(np.abs(y2 - l2_cpu.decode(torch.as_tensor(c2)).numpy()
                          ).max())
    try:
        l2_card(torch.as_tensor(norm[:2].astype(np.float32), device=dev))
        raise SystemExit("levels=2 training forward did not raise")
    except ValueError as e:
        reason = str(e)
    log(f"phase 19 levels=2 (downs_t (3, 1)): encode {c2.shape}, decode "
        f"{y2.shape} card vs CPU {y2_err:.3e}; training forward refused: "
        f"{reason}")
    if c2.shape != (allb.shape[0], 15) or y2.shape != (allb.shape[0], 120,
                                                       135) or \
            y2_err > POSE_ATOL:
        raise SystemExit("phase 19: levels=2 encode / decode")

    # the JAX package's .msgpack file, written by this script
    tree = vqvae_state_dict_to_jax(models["default"].state_dict(),
                                   models["default"].cfg)
    flax_msgpack.save(p("p19_vqvae.msgpack"), tree)
    torch.save({"model_dict": models["default"].state_dict()},
               p("p19_vqvae.bin"))
    with open(p("p19.yml"), "w") as f:
        yaml.safe_dump({"VQVAE": {"conv_precision": "default"},
                        "data_mean": mean.tolist(),
                        "data_std": std.tolist()}, f)
    with open(p("p19_pipeline.json"), "w") as f:
        f.write(built["pipeline"].to_json())
    np.savez(p("p19_result.npz"), knn_pred=got)
    outs = {}
    for kind in ("msgpack", "bin"):
        cli(["decode", "--result", p("p19_result.npz"), "--checkpoint",
             p(f"p19_vqvae.{kind}"), "--config", p("p19.yml"),
             "--pipeline", p("p19_pipeline.json"), "--out", p(f"p19_{kind}"),
             "--prefix", "p19", "--device", str(dev)])
        with open(p(f"p19_{kind}", "p19_generated.bvh"), "rb") as f:
            outs[kind] = f.read()
    native = load_vqvae_native(p("p19_vqvae.msgpack"), models["default"].cfg,
                               device=dev)
    codes_t = torch.as_tensor(got, device=dev)
    same = torch.equal(native.decode(codes_t),
                       models["default"].decode(codes_t))
    log(f"phase 19 .msgpack ({os.path.getsize(p('p19_vqvae.msgpack'))} "
        f"bytes, flax layout): decode from the file == decode from the "
        f"state_dict {same}; decode --checkpoint x.msgpack BVH == from the "
        f".bin {outs['msgpack'] == outs['bin']}")
    if not same or outs["msgpack"] != outs["bin"]:
        raise SystemExit("phase 19: the .msgpack VQ-VAE decodes otherwise")
    return codes["default"], sig, n1


def phase19_simple_vqvae(dev, rng):
    """SimpleVQVAE at VQVAEConfig's widths: forward(train=True) and its
    gradient at P19_BATCH x 240 (ms, windows/s, idle share); card against
    the CPU port at P19_CHECK_BATCH (codes, loss, gradients)."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.core.config import VQVAEConfig
    from qpgesture_tpu_torch.device import cudnn_autotune
    from qpgesture_tpu_torch.models import bottleneck as bn
    from qpgesture_tpu_torch.models.simple_vqvae import SimpleVQVAE

    cfg = VQVAEConfig()
    x = torch.as_tensor(np.stack([c["poses"][:240] for c in training_clips(
        rng, P19_BATCH, 240)]))
    torch.manual_seed(SEED)
    card = SimpleVQVAE(cfg, device=dev)
    with torch.no_grad():
        h = card.encoder(x.to(dev))
    card.bottleneck.level_blocks[0].set_state(*bn.init_codebook(
        h.reshape(-1, cfg.emb_width), cfg.l_bins,
        torch.Generator(dev).manual_seed(SEED)))
    cpu = SimpleVQVAE(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    xb = x[:P19_CHECK_BATCH]
    codes_cpu, codes_card = cpu.encode(xb), card.encode(xb.to(dev)).cpu()
    _, loss_cpu, _ = cpu(xb)
    loss_cpu.backward()
    _, loss_card, _ = card(xb.to(dev))
    loss_card.backward()
    loss_err = abs(loss_card.item() - loss_cpu.item()) / loss_cpu.item()
    g_err = grad_err(card, cpu)
    n_params = sum(q.numel() for q in card.parameters())
    log(f"phase 19 SimpleVQVAE ({n_params} parameters) card vs CPU port at "
        f"batch {P19_CHECK_BATCH}: loss rel {loss_err:.3e} (tol "
        f"{TRAIN_LOSS_RTOL}), gradients {g_err[0]:.3e} (tol "
        f"{TRAIN_GRAD_RTOL})")
    with torch.no_grad():
        h = card.encoder(xb.to(dev))
    check_code_flips("phase 19 SimpleVQVAE encode", lambda n: h[n],
                     card.codebook, codes_card.numpy(), codes_cpu.numpy())
    if loss_err > TRAIN_LOSS_RTOL or g_err[0] > TRAIN_GRAD_RTOL:
        raise SystemExit("phase 19: SimpleVQVAE card differs from CPU")
    del cpu
    card.train()
    xd = x.to(dev)
    gen = torch.Generator(dev).manual_seed(SEED)

    def step():
        # the trainers' setting: cuDNN times its algorithms for each conv
        # shape (its heuristic takes FFT convs here, ~9x slower on an H100)
        with cudnn_autotune():
            card.zero_grad(set_to_none=True)
            card(xd, train=True, generator=gen)[1].backward()

    ms = median_ms(step, TRAIN_TIMED_STEPS)
    log(f"phase 19 SimpleVQVAE forward(train=True) + backward at batch "
        f"{P19_BATCH} x 240 under cudnn_autotune: {ms:.3f} ms (CUDA events, "
        f"median of {TRAIN_TIMED_STEPS}) = {1e3 * P19_BATCH / ms:.1f} "
        f"windows/s")
    log_profile("phase 19 SimpleVQVAE step", lambda: (step(), sync(dev)))
    return ms


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def phase19_seq2seq(dev, rng):
    """Seq2SeqNet at the seq2seq configuration of Yoon et al.'s trimodal
    gesture code (SEQ2SEQ): eval forward and a train-mode forward with its
    gradient at SEQ2SEQ_BATCH (ms and idle share: the decoder is a host
    loop of 33 steps); card against the CPU port (eval outputs, and at
    dropout 0 the train-mode gradients and BatchNorm statistics)."""
    import copy as copy_

    import numpy as np
    import torch
    from qpgesture_tpu_torch.models.seq2seq import Seq2SeqNet

    s = SEQ2SEQ
    torch.manual_seed(SEED)
    cpu = Seq2SeqNet(s["vocab"], s["embed"], s["hidden"], s["pose"],
                     s["frames"], s["pre"], s["layers"], s["dropout"],
                     device="cpu")
    card = copy_.deepcopy(cpu).to(dev)
    B = SEQ2SEQ_BATCH
    lengths = rng.randint(2, SEQ2SEQ_WORDS + 1, B)
    tokens = rng.randint(1, s["vocab"], (B, SEQ2SEQ_WORDS))
    for b, n in enumerate(lengths):
        tokens[b, n:] = 0
    tokens = torch.as_tensor(tokens)
    poses = torch.as_tensor(rng.randn(B, s["frames"], s["pose"]).astype(
        np.float32))
    tok_d, poses_d = tokens.to(dev), poses.to(dev)
    with torch.no_grad():
        want = cpu(tokens, lengths, poses)
        got = card(tok_d, lengths, poses_d).cpu()
    err = float((got - want).abs().max())
    # train mode at dropout 0, so that both devices compute the same step
    for m in (cpu, card):
        m.train()
        m.encoder.dropout = m.decoder.decoder.dropout_p = 0.0
        m(tok_d if m is card else tokens, lengths,
          poses_d if m is card else poses).pow(2).mean().backward()
    # the Linear in front of the training-mode BatchNorm: gradient 0
    # analytically, rounding noise on both devices
    g_err = grad_err(card, cpu, zero_grad=("decoder.decoder.pre_linear.0."
                                           "bias",))
    st_err = bn_stats_err(card, cpu)
    n_params = sum(q.numel() for q in card.parameters())
    log(f"phase 19 Seq2SeqNet ({n_params} parameters: vocab {s['vocab']}, "
        f"embed {s['embed']}, hidden {s['hidden']}, {s['layers']} layers, "
        f"{s['frames']} poses of {s['pose']} with {s['pre']} teacher-forced)"
        f" at batch {B}: eval card vs CPU {err:.3e} (tol {SEQ2SEQ_ATOL}); "
        f"train mode (dropout 0) gradients {g_err[0]:.3e} (tol "
        f"{TRAIN_GRAD_RTOL}), BatchNorm statistics {st_err:.3e} (tol "
        f"{TRAIN_STATS_RTOL})")
    if err > SEQ2SEQ_ATOL or g_err[0] > TRAIN_GRAD_RTOL or \
            st_err > TRAIN_STATS_RTOL:
        raise SystemExit("phase 19: Seq2SeqNet card differs from CPU")
    del cpu
    card.encoder.dropout = card.decoder.decoder.dropout_p = s["dropout"]
    gen = torch.Generator(dev).manual_seed(SEED)

    def train_step():
        card.zero_grad(set_to_none=True)
        card(tok_d, lengths, poses_d, generator=gen).pow(2).mean().backward()

    def eval_fwd():
        with torch.no_grad():
            card(tok_d, lengths, poses_d)

    card.eval()
    eval_ms = median_ms(eval_fwd, 10)
    log_profile("phase 19 Seq2SeqNet eval forward", lambda: (eval_fwd(),
                                                             sync(dev)))
    card.train()
    train_ms = median_ms(train_step, 10)
    log_profile("phase 19 Seq2SeqNet train forward + backward",
                lambda: (train_step(), sync(dev)))
    log(f"phase 19 Seq2SeqNet at batch {B}: eval forward {eval_ms:.3f} ms, "
        f"train forward + backward {train_ms:.3f} ms (CUDA events, median "
        f"of 10; host in the loop)")
    return eval_ms, train_ms


def write_trinity_split(base: str, rng, n_recs: int, minutes: float,
                        first: int) -> None:
    """A Trinity-layout split: Motion/*.bvh (the BEAT-like skeleton at 120
    fps, smooth motion), Audio/*.wav (16 kHz speech-like), Transcripts/
    *.json (GENEA's Google-Speech layout, ~2.5 words a second)."""
    import json

    import numpy as np
    from qpgesture_tpu_torch.pipelines.audio_prep import write_wav
    vocab = ("so the idea is that we move our hands when we speak and this "
             "gesture follows the rhythm of the voice").split()
    for d in ("Motion", "Audio", "Transcripts"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    for i in range(n_recs):
        name = f"Recording_{first + i:03d}"
        seconds = 60.0 * minutes
        with open(os.path.join(base, "Motion", name + ".bvh"), "w") as f:
            f.write(skeleton_bvh_text(rng, int(seconds * 120), 120,
                                      smooth=True))
        write_wav(os.path.join(base, "Audio", name + ".wav"),
                  speech_like(rng, seconds), 16000)
        t, words = 0.0, []
        while t < seconds - 1:
            d = rng.uniform(0.15, 0.6)
            words.append({"start_time": f"{t:.3f}s",
                          "end_time": f"{t + d:.3f}s",
                          "word": str(rng.choice(vocab))})
            t += d + rng.uniform(0.02, 0.3)
        with open(os.path.join(base, "Transcripts", name + ".json"),
                  "w") as f:
            json.dump([{"alternatives": [{"words": words}]}], f)


def phase19_trinity(dev, rng, tmp: str):
    """build-db --dataset trinity in both modes on a synthetic split
    (TRINITY_TRAIN recordings of TRINITY_MINUTES + TRINITY_VAL), host wall
    per recording; the rotation store's windows (train/data.py) gathered by
    DeviceClipStore on the card equal to the host windows."""
    import numpy as np
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.pipelines.trinity import load_trinity_store
    from qpgesture_tpu_torch.train.data import (DeviceClipStore,
                                                WindowedDataset)
    p = lambda *names: os.path.join(tmp, *names)
    t0 = time.time()
    write_trinity_split(p("trn"), rng, TRINITY_TRAIN, TRINITY_MINUTES, 0)
    write_trinity_split(p("val"), rng, TRINITY_VAL, TRINITY_MINUTES,
                        TRINITY_TRAIN)
    n_recs = TRINITY_TRAIN + TRINITY_VAL
    log(f"phase 19 Trinity split written: {TRINITY_TRAIN} + {TRINITY_VAL} "
        f"recordings of {TRINITY_MINUTES} min (BVH at 120 fps, 16 kHz wav, "
        f"GENEA JSON); {time.time() - t0:.1f} s")
    for mode in ("rotation", "position"):
        t0 = time.time()
        cli(["build-db", "--dataset", "trinity", "--trn-path", p("trn"),
             "--val-path", p("val"), "--mode", mode, "--out",
             p(f"trinity_{mode}"), "--device", str(dev)])
        wall = time.time() - t0
        clips = load_trinity_store(p(f"trinity_{mode}", "lmdb_train"))
        stats = np.load(p(f"trinity_{mode}", "stats.npz"))
        log(f"phase 19 build-db --dataset trinity --mode {mode}: {wall:.1f} "
            f"s = {wall / n_recs:.1f} s a recording (host wall); train store "
            f"{len(clips)} clips of {clips[0]['poses'].shape}, "
            f"{len(clips[0]['words'])} words, audio "
            f"{clips[0]['audio'].shape}; stats {stats['mean'].shape}")
        want = 2 * TRINITY_TRAIN if mode == "rotation" else TRINITY_TRAIN
        if len(clips) != want or not all(np.isfinite(c["poses"]).all()
                                         for c in clips):
            raise SystemExit(f"phase 19: Trinity {mode} store")
        if mode == "rotation":
            mean, std = stats["mean"], stats["std"]
            poses = [{"poses": c["poses"]} for c in clips]
            host_ds = WindowedDataset.from_clips(poses, 240, 32,
                                                 data_mean=mean, data_std=std)
            b = min(64, len(host_ds))
            store = DeviceClipStore(poses, 240, 32, mean, std, device=dev)
            got = next(iter(store.batches(b, seed=0))).cpu().numpy()
            host = next(iter(host_ds.batches(b, seed=0)))
            log(f"phase 19 Trinity rotation windows: DeviceClipStore batch "
                f"{got.shape} == the host batch {np.array_equal(got, host)}")
            if not np.array_equal(got, host):
                raise SystemExit("phase 19: Trinity windows differ")


def phase19_analytics(codes, signature) -> None:
    from qpgesture_tpu_torch.render.analytics import (code_frequency,
                                                      signature_pca)
    top = code_frequency(codes, top=5)
    pca = signature_pca(signature, 2)
    log(f"phase 19 analytics of the \"default\" codes: top codes {top}; "
        f"signature PCA {pca.shape}; plot and generate --video are held on "
        f"the CPU (this machine has no matplotlib)")
    if pca.shape != (signature.shape[0], 2) or not top:
        raise SystemExit("phase 19: analytics")


def load_wav(path: str):
    from qpgesture_tpu_torch.pipelines.audio_prep import load_wav_16k
    return load_wav_16k(path)


# -- phase 20: process groups on the card -----------------------------------
# the database of phase 20: 4x phase 4's J (the shipped features ~2.6 GB
# float32 staged), requests of W windows, C clips of predict_batch_sharded
# and C streams of the pool, the tick schedule (sharded, plain, sharded),
# the groups (world, backend; gloo ranks share cuda:0), timed repetitions
P20_J, P20_C = 4 * J, 8
P20_TICKS = (True, False, True)
P20_GROUPS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
P20_REPS = 3
# data-parallel training: each trainer's configuration batch in 2 ranks,
# its timed steps; the CLIs under torchrun: match's database (sequences)
# and train-vqvae's cut epoch (windows)
P20_TRAIN = {"VQVAE": 256, "PAE": 32, "end2end": 32, "resync": 100}
P20_TIMED = 3
P20_CLI_J, P20_CLI_WINDOWS = 512, 512
# ResyncNet's data-parallel losses against one device's, relative (1 below
# |loss| 1): the critic's loss at initialization moves with its fakes'
# rounding (a LeakyReLU slope inside the penalty's double backward flips,
# see RESYNC_GRAD_RTOL). Fakes ~1e-6 apart (the generator's BatchNorm
# statistics summed over two blocks) moved it by up to 1.5e-5 at batch 4
# on the CPU and by 2.2e-5 (flax's statistics) / 5.6e-5 (two-pass) at
# batch 100 on an H100; a step that drops a rank's gradients or shards the
# interpolation points wrongly moves it by O(1e-1)
P20_RESYNC_LOSS_RTOL = 2e-4


def save_db(db, path: str) -> None:
    """A MatchDatabase as one .npy per array (the ranks memory-map them)
    and a pickle of the rest."""
    import pickle
    import numpy as np
    os.makedirs(path, exist_ok=True)
    rest = {}
    for f in dataclasses.fields(db):
        value = getattr(db, f.name)
        if isinstance(value, np.ndarray):
            np.save(os.path.join(path, f.name + ".npy"), value)
        else:
            rest[f.name] = value
    with open(os.path.join(path, "rest.pkl"), "wb") as f:
        pickle.dump(rest, f)


def load_db(path: str):
    """save_db's database, every array memory-mapped (copy on write, so
    torch may wrap them): a rank reads only the rows of its shard and the
    small replicated tables."""
    import pickle
    import numpy as np
    from qpgesture_tpu_torch.match.database import MatchDatabase
    with open(os.path.join(path, "rest.pkl"), "rb") as f:
        rest = pickle.load(f)
    arrays = {name[:-4]: np.load(os.path.join(path, name), mmap_mode="c")
              for name in os.listdir(path) if name.endswith(".npy")}
    return MatchDatabase(**rest, **arrays)


def host_ms(fn, n: int = P20_REPS):
    """(the last result, median host ms) of n calls of fn after one
    warm-up; fn returns host arrays, so each call has synchronised."""
    out = fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, statistics.median(times)


def oracle_tuple(r):
    return (r.codes, r.phases, r.votes)


def tensor_bytes(*objs) -> int:
    """Bytes of the tensors in objs, through tuples, lists and
    dataclasses (None counts 0)."""
    import torch
    parts, total = list(objs), 0
    while parts:
        x = parts.pop()
        if isinstance(x, (tuple, list)):
            parts.extend(x)
        elif dataclasses.is_dataclass(x):
            parts.extend(getattr(x, f.name) for f in dataclasses.fields(x))
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def resident_bytes(dev, stage) -> int:
    """The device bytes that stage() leaves allocated: memory_allocated's
    growth on a card; on the CPU (a rehearsal) the bytes of the tensors it
    returns."""
    import torch
    if dev.type != "cuda":
        return tensor_bytes(stage())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    stage()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(dev) - before


def phase20_setup(dev, rng, tmp: str, enc_cpu, vq_cpu, data_mean, data_std):
    """Phase 20's databases (J=P20_J: wavvq and shipped), requests and
    models, written to tmp for the ranks, and the single-device references
    on the card: predict, predict_batch, serve and three pool ticks, their
    request ms and the shipped database's resident bytes. Returns (the
    references, make_data's arrays for the CLIs)."""
    import pickle
    import numpy as np
    import torch
    from qpgesture_tpu_torch.core.config import MATCH_PRESETS
    from qpgesture_tpu_torch.match.database import (stage_database,
                                                    stage_test_audio,
                                                    stage_test_context)
    from qpgesture_tpu_torch.match.engine import CodeKNNEngine
    from qpgesture_tpu_torch.serve import RawWavServer, StreamingPool

    t0 = time.time()
    bundle, codes, signature, wavvq, clips = make_data(rng, P20_J)
    cfg_w, cfg_s = MATCH_PRESETS["wavvq"], MATCH_PRESETS["shipped"]
    db_w = stage_database(cfg_w, bundle, codes, signature, wavvq=wavvq)
    # the shipped database with random staged features: its tables come
    # from a one-channel WavLM stand-in, whose staging (phases 4-19 run the
    # real one) would cost the full-width interpolation of 3.3 GB
    db_s = stage_database(cfg_s, bundle, codes, signature,
                          wavlm=np.zeros((P20_J, 199, 1), np.float32))
    B = db_s.aud_feat.shape[1]
    db_s = dataclasses.replace(db_s, aud_feat=np.random.default_rng(
        SEED + 20).random((P20_J, B, 6 * 1024), dtype=np.float32) - 0.5)
    save_db(db_w, os.path.join(tmp, "db_wavvq"))
    save_db(db_s, os.path.join(tmp, "db_shipped"))
    torch.save(enc_cpu.state_dict(), os.path.join(tmp, "wavlm.pt"))
    torch.save(vq_cpu.state_dict(), os.path.join(tmp, "vqvae.pt"))
    wv, ctx = clips[0]
    ta_w = stage_test_audio(cfg_w, db_w, wavvq=wv)
    tc_w = stage_test_context(db_w, ctx)
    ta_s = stage_test_audio(cfg_s, db_s, wavlm=rng.randn(
        W, 199, 1024).astype(np.float32))
    batch = [np.stack([stage_test_audio(cfg_w, db_w, wavvq=c[0])
                       for c in clips[:P20_C // 2]] * 2),
             np.stack([stage_test_context(db_w, c[1])
                       for c in clips[:P20_C // 2]] * 2)]
    ticks = [(np.stack([ta_w[(t + i) % W] for i in range(P20_C)]),
              np.stack([tc_w[(t + i) % W] for i in range(P20_C)]))
             for t in range(len(P20_TICKS))]
    wav = (rng.randn(W, 64000) * 3000).astype(np.int16)
    inputs = dict(ta_w=ta_w, tc_w=tc_w, ta_s=ta_s, batch=batch, ticks=ticks,
                  wav=wav, ctx=ctx, mean=data_mean, std=data_std,
                  train=phase20_train_inputs(rng))
    with open(os.path.join(tmp, "p20.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    log(f"phase 20 set-up: J={P20_J} databases (wavvq strings "
        f"{db_w.aud_strings.nbytes / 1e6:.0f} MB, shipped features "
        f"{db_s.aud_feat.nbytes / 1e9:.2f} GB float32) written for the "
        f"ranks to memory-map; {time.time() - t0:.1f} s")

    seed = cfg_w.seed
    eng_w = CodeKNNEngine(cfg_w, db_w, device=dev)
    held = []

    def stage():        # the engine's construction and its database
        held.append(CodeKNNEngine(cfg_s, db_s, device=dev))
        return held[0].dev, held[0].devdb

    ref = {"resident": resident_bytes(dev, stage)}
    eng_s = held[0]
    ref["engine"] = tensor_bytes(eng_s.dev)
    rs = lambda: np.random.RandomState(seed)
    ref["predict wavvq"], ref["ms predict wavvq"] = host_ms(
        lambda: oracle_tuple(eng_w.predict(ta_w, tc_w, rng=rs())))
    ref["predict shipped"], ref["ms predict shipped"] = host_ms(
        lambda: oracle_tuple(eng_s.predict(ta_s, tc_w, rng=rs())))
    ref["batch"] = [oracle_tuple(r) for r in eng_w.predict_batch(
        *batch, rng=rs())]
    server = RawWavServer(eng_s, copy.deepcopy(vq_cpu).to(dev),
                          copy.deepcopy(enc_cpu).to(dev), data_mean,
                          data_std)
    ref["serve"], ref["ms serve"] = host_ms(lambda: server.serve(
        wav, ctx, init_code=0, rng=rs()))
    pool = StreamingPool(eng_w, P20_C)
    ref["tick"] = ([pool.tick(*t) for t in ticks],
                   tuple(x.cpu().numpy() for x in pool.state()))
    log(f"phase 20 single device (no group): request ms predict wavvq "
        f"{ref['ms predict wavvq']:.3f}, predict shipped "
        f"{ref['ms predict shipped']:.3f}, serve shipped raw wav "
        f"{ref['ms serve']:.3f}; shipped engine and database resident "
        f"{ref['resident'] / 1e9:.3f} GB, of which the engine's "
        f"DeviceDatabase {ref['engine'] / 1e6:.3f} MB")
    del server, pool, eng_w, eng_s
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ref, (bundle, codes, signature, wavvq, clips)


def phase20_train_inputs(rng):
    """One batch of each trainer at its configuration's batch size."""
    import numpy as np
    n = P20_TRAIN
    return dict(
        VQVAE=(rng.randn(n["VQVAE"], 240, 135) * 0.5).astype(np.float32),
        PAE=(rng.randn(n["PAE"], 240, 135) * 0.5).astype(np.float32),
        end2end=((rng.randn(n["end2end"], 64000) * 0.1).astype(np.float32),
                 rng.randint(0, 512, (n["end2end"], 30)).astype(np.int32)),
        resync=(rng.randn(n["resync"], 240, 13 + 135).astype(np.float32),
                rng.randn(n["resync"], 240, 13 + 135).astype(np.float32),
                rng.rand(n["resync"], 1, 1).astype(np.float32)))


def phase20_trainers(dev):
    """Each trainer built from SEED on dev, and its step on a batch."""
    from qpgesture_tpu_torch.core.config import (End2EndConfig, PAEConfig,
                                                 ResyncConfig, TrainConfig,
                                                 VQVAEConfig)
    from qpgesture_tpu_torch.train.train_end2end import End2EndTrainer
    from qpgesture_tpu_torch.train.train_pae import PAETrainer
    from qpgesture_tpu_torch.train.train_resync import ResyncTrainer
    from qpgesture_tpu_torch.train.train_vqvae import VQVAETrainer
    import torch
    vq = VQVAETrainer(VQVAEConfig(), TrainConfig(), device=dev, seed=SEED)
    pae = PAETrainer(PAEConfig(), device=dev, seed=SEED)
    e2e = End2EndTrainer(End2EndConfig(), device=dev, seed=SEED)
    rs = ResyncTrainer(ResyncConfig(), n_mfcc=13, n_joints=135,
                       num_frames=240, device=dev, seed=SEED)
    return {
        "VQVAE": (vq, vq.model, lambda x: vq.train_step(x)[0]),
        "PAE": (pae, pae.model, pae.train_step),
        "end2end": (e2e, e2e.model, lambda b: e2e.train_step(*b)),
        "resync": (rs, rs, lambda b: rs.train_iteration(
            b[0], b[1], 0, torch.as_tensor(b[2]))),
    }


def _named_grads(module, prefix=""):
    return {prefix + n: p.grad.detach().cpu() for n, p in
            module.named_parameters() if p.grad is not None}


def resync_check_step(trainer, batch, critic: str, save: bool):
    """One critic step and one generator step of a ResyncTrainer on its
    block of batch (all of it in one process), the generator step scoring
    against the critic in the file ``critic``, which the one-device
    reference writes (save) after its critic step: Adam with b1 = 0 moves
    each weight by about lr times its gradient's sign, so the weights whose
    gradient is rounding noise would leave two critics ~lr apart (as in
    phase 18). Returns (losses, gradients)."""
    import torch
    from qpgesture_tpu_torch.parallel.dist import local_block
    x_knn, x_real, eps = batch
    eps = torch.as_tensor(eps)
    if trainer.group is not None:
        x_knn, x_real = trainer.shard((x_knn, x_real))
        eps = local_block(eps, trainer.group)
    d_loss = trainer.d_step(x_knn, x_real, eps)
    grads = _named_grads(trainer.disc, "disc.")
    if save:
        torch.save(trainer.disc.state_dict(), critic)
    trainer.disc.load_state_dict(torch.load(critic))
    g_loss = trainer.g_step(x_knn, x_real)
    return ({"d_loss": float(d_loss), "g_loss": float(g_loss)},
            {**grads, **_named_grads(trainer.gen, "gen.")})


def phase20_train_rank(dev, inputs, tmp: str, prefix: str):
    """One data-parallel step of each trainer on its configuration's batch
    (this rank takes its block; ResyncNet's by resync_check_step), then the
    step's time and idle share. Returns {trainer: (losses, gradients)}
    (gradients on rank 0 only)."""
    import torch
    from qpgesture_tpu_torch.parallel.dist import rank
    out = {}
    for name, (trainer, _, step) in phase20_trainers(dev).items():
        batch = inputs[name]
        if name == "VQVAE":
            trainer.init_codebook(batch)
        if name == "resync":
            losses, grads = resync_check_step(
                trainer, batch, os.path.join(tmp, "p20_critic.pt"), False)
        else:
            loss = step(batch)
            losses = {"loss": float(loss)}
            grads = _named_grads(trainer.model)
        out[name] = (losses, grads if rank() == 0 else None)
        on_card = tuple(torch.as_tensor(b).to(dev) for b in batch) \
            if isinstance(batch, tuple) else torch.as_tensor(batch).to(dev)
        if rank() == 0:
            time_trainer(f"{name} data-parallel step (batch "
                         f"{P20_TRAIN[name]})", lambda: step(on_card),
                         P20_TRAIN[name], n=P20_TIMED, phase=prefix)
        else:   # the same steps: each one meets the others' collectives
            for _ in range(3 + P20_TIMED + 3):
                step(on_card)
    return out


def phase20_train_reference(dev, inputs, world: int, tmp: str):
    """The references of phase20_train_rank on one device: the VQ-VAE and
    ResyncNet (whose generator's BatchNorms the group synchronises, in
    flax's formula, which the reference takes too) step on the whole
    batch; the PAE and the GRU, whose BatchNorms normalise each
    rank's block, as the mean over the world's blocks of one step's loss and
    gradients, each block from the same state (the GRU's dropout generator
    too), as the JAX trainers' per-shard statistics have it. ResyncNet's
    critic after its step goes to tmp for the ranks' generator steps."""
    import torch
    from qpgesture_tpu_torch.models.batchnorm import sync_batchnorm
    from qpgesture_tpu_torch.train.train_pae import pae_loss
    out = {}
    for name, (trainer, module, step) in phase20_trainers(dev).items():
        batch = inputs[name]
        if name == "resync":
            sync_batchnorm(trainer.gen)
            out[name] = resync_check_step(
                trainer, batch, os.path.join(tmp, "p20_critic.pt"), True)
            continue
        if name == "VQVAE":
            trainer.init_codebook(batch)
            out[name] = ({"loss": float(step(batch))},
                         _named_grads(trainer.model))
            continue
        module.train()
        gen_state = getattr(trainer, "generator", None)
        gen_state = gen_state.get_state() if gen_state is not None else None
        loss_sum, grads = 0.0, None
        n = P20_TRAIN[name] // world
        for r in range(world):
            module.zero_grad(set_to_none=True)
            if name == "PAE":
                loss = pae_loss(module, torch.as_tensor(
                    batch[r * n:(r + 1) * n]).to(dev))
            else:
                trainer.generator.set_state(gen_state)
                wav, codes = (torch.as_tensor(b[r * n:(r + 1) * n]).to(dev)
                              for b in batch)
                loss = module(wav, codes.long(),
                              generator=trainer.generator)[1]
            loss.backward()
            loss_sum += float(loss.detach())
            g = _named_grads(module)
            grads = g if grads is None else {k: grads[k] + g[k] for k in g}
        out[name] = ({"loss": loss_sum / world},
                     {k: v / world for k, v in grads.items()})
    return out


def phase20_rank(tmp: str, device: str, train: bool):
    """What every rank of phase 20's groups runs on ``device``: the sharded
    serving surface over the J=P20_J databases of phase20_setup (each rank
    stages its shard from the memory-mapped files), with per-rank tables
    and combine times, request times and resident bytes (the shipped
    engine's construction and its shard); with ``train``, one data-parallel
    step of each trainer. Returns the results, K1's, K2's, K3's and K7's
    launches in this process (K7's without the timing loops) and the
    times."""
    import pickle
    import numpy as np
    import torch
    from qpgesture_tpu_torch.core.config import MATCH_PRESETS, VQVAEConfig
    from qpgesture_tpu_torch.match.engine import CodeKNNEngine
    from qpgesture_tpu_torch.models.vqvae import VQVAE
    from qpgesture_tpu_torch.models.wavlm import WavLM, WavLMConfig
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.ops import fusion_scan_cuda as K3
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.ops import segmin_cuda as K7
    from qpgesture_tpu_torch.parallel import dist as pd
    from qpgesture_tpu_torch.parallel.sharded_match import (combine_minargs,
                                                            shard_minargs)
    from qpgesture_tpu_torch.serve import RawWavServer, StreamingPool

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    r, n = pd.rank(), pd.world_size()
    backend = torch.distributed.get_backend()
    prefix = f"phase 20 [{n} {backend} rank {r}]"
    with open(os.path.join(tmp, "p20.pkl"), "rb") as f:
        inp = pickle.load(f)
    cfg_w, cfg_s = MATCH_PRESETS["wavvq"], MATCH_PRESETS["shipped"]
    engine = lambda cfg, name: CodeKNNEngine(  # noqa: E731
        cfg, load_db(os.path.join(tmp, name)), device=dev)
    eng_w = engine(cfg_w, "db_wavvq")
    K1.launches = K2.launches = K3.launches = K7.launches = 0
    out = {"rank": r}
    held = []

    def stage():        # the engine's construction and this rank's shard
        held.append(engine(cfg_s, "db_shipped"))
        return held[-1].dev, held[-1].sharded_db(None)

    t0 = time.perf_counter()
    out["resident"] = resident_bytes(dev, stage)
    stage_s = time.perf_counter() - t0
    eng_s = held[-1]
    out["engine"] = tensor_bytes(eng_s.dev)
    rs = lambda: np.random.RandomState(cfg_w.seed)
    ta_w, tc_w, ta_s = inp["ta_w"], inp["tc_w"], inp["ta_s"]
    out["predict wavvq"], out["ms predict wavvq"] = host_ms(
        lambda: oracle_tuple(eng_w.predict_sharded(None, ta_w, tc_w,
                                                   rng=rs())))
    out["predict shipped"], out["ms predict shipped"] = host_ms(
        lambda: oracle_tuple(eng_s.predict_sharded(None, ta_s, tc_w,
                                                   rng=rs())))
    out["batch"] = [oracle_tuple(x) for x in eng_w.predict_batch_sharded(
        None, *inp["batch"], rng=rs())]
    with uncounted():
        for name, eng, ta in (("wavvq", eng_w, ta_w),
                              ("shipped", eng_s, ta_s)):
            qa, qc = eng.stage_queries(ta, tc_w)
            out[f"tables_ms {name}"] = median_ms(
                lambda: eng.tables(qa, qc, sharded=True), 5)
        side = eng_s.sharded_db(None).aud
        mins, args = shard_minargs(cfg_s, torch.as_tensor(ta_s).to(
            dev).reshape(-1, ta_s.shape[-1]), side, False)
    out["combine_ms"] = median_ms(lambda: combine_minargs(cfg_s, mins, args),
                                  10)
    with torch.device(dev):     # initialised on the card, then overwritten
        enc = WavLM(WavLMConfig(), device=dev)
        vq = VQVAE(VQVAEConfig(), device=dev)
    enc.load_state_dict(torch.load(os.path.join(tmp, "wavlm.pt"),
                                   map_location=dev))
    vq.load_state_dict(torch.load(os.path.join(tmp, "vqvae.pt"),
                                  map_location=dev))
    server = RawWavServer(eng_s, vq, enc, inp["mean"], inp["std"])
    k2_before = K2.launches
    out["serve"], out["ms serve"] = host_ms(lambda: server.serve_sharded(
        None, inp["wav"], inp["ctx"], init_code=0, rng=rs()))
    out["k2 per serve"] = ((K2.launches - k2_before) / (P20_REPS + 1),
                           enc.cfg.encoder_layers if dev.type == "cuda"
                           else 0)
    pool = StreamingPool(eng_w, P20_C)
    out["tick"] = ([pool.tick_sharded(None, *t) if s else pool.tick(*t)
                    for t, s in zip(inp["ticks"], P20_TICKS)],
                   tuple(x.cpu().numpy() for x in pool.state()))
    del pool, eng_w, eng_s, held[:]
    log(f"{prefix}: holds the shipped engine's DeviceDatabase "
        f"{out['engine'] / 1e6:.3f} MB")
    out["k1"], out["k2"], out["k3"] = K1.launches, K2.launches, K3.launches
    out["k7"] = K7.launches
    if r == 0:
        host = ": CUDA tensors through host copies" \
            if backend == "gloo" else ""
        log(f"{prefix}: shard staged in {stage_s:.2f} s, resident "
            f"{out['resident'] / 1e9:.3f} GB; tables_ms wavvq "
            f"{out['tables_ms wavvq']:.3f} shipped "
            f"{out['tables_ms shipped']:.3f}; combine_ms "
            f"{out['combine_ms']:.3f} ({backend}{host}"
            f"); request ms predict wavvq {out['ms predict wavvq']:.3f}, "
            f"shipped {out['ms predict shipped']:.3f}, serve_sharded "
            f"{out['ms serve']:.3f}; launches K1 {out['k1']}, K2 "
            f"{out['k2']}, K7 {out['k7']}")
    del server, enc, vq
    if train:
        out["train"] = phase20_train_rank(dev, inp["train"], tmp, prefix)
    return out


def phase20_check(world: int, backend: str, ranks: list, ref: dict,
                  train_ref) -> tuple:
    """Every rank's results against the single-device references, bit for
    bit; the shard's resident bytes about 1/world of the single device's
    database (the engine's DeviceDatabase is whole on every rank). Returns
    the group's K1 and K2 launches."""
    import numpy as np

    def same(a, b, what):
        if isinstance(a, (tuple, list)):
            if len(a) != len(b):
                raise SystemExit(f"phase 20 {what}: {len(a)} vs {len(b)}")
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{what}[{i}]")
        elif (a is None) != (b is None) or (
                a is not None and not np.array_equal(a, b)):
            raise SystemExit(f"phase 20 [{world} {backend}]: {what} "
                             "differs from the single device")

    shard = lambda o: o["resident"] - o["engine"]
    for out in ranks:
        for key in ("predict wavvq", "predict shipped", "batch", "serve",
                    "tick"):
            same(out[key], ref[key], f"rank {out['rank']} {key}")
        share = shard(out) / shard(ref)
        if not 0.9 / world < share < 1.1 / world + 0.02:
            raise SystemExit(f"phase 20 [{world} {backend}]: rank resident "
                             f"{share:.3f} of one device's database")
        if out["engine"] != ref["engine"]:
            raise SystemExit(f"phase 20 [{world} {backend}]: the rank's "
                             f"engine differs from the single device's")
        got, want = out["k2 per serve"]
        if got != want:
            raise SystemExit(f"serve_sharded launched K2 {got} times a "
                             f"request, not {want} (one per layer)")
    k1 = sum(o["k1"] for o in ranks)
    k2 = sum(o["k2"] for o in ranks)
    shares = [round(shard(o) / shard(ref), 4) for o in ranks]
    log(f"phase 20 [{world} {backend}]: every rank's codes, phases, votes, "
        f"poses and carried seeds == the single device's (predict wavvq / "
        f"shipped, predict_batch_sharded C={P20_C}, serve_sharded, "
        f"{len(P20_TICKS)} interleaved ticks of {P20_C} streams); shard "
        f"resident per rank {shares} of one device's database "
        f"{shard(ref) / 1e9:.3f} GB; engine + shard per rank "
        f"{[round(o['resident'] / 1e9, 4) for o in ranks]} GB, of which "
        f"the engine's DeviceDatabase {ranks[0]['engine'] / 1e6:.3f} MB "
        f"on every rank, against "
        f"one device's {ref['resident'] / 1e9:.3f} GB; request ms rank 0"
        f" vs one device: predict wavvq {ranks[0]['ms predict wavvq']:.3f} /"
        f" {ref['ms predict wavvq']:.3f}, shipped "
        f"{ranks[0]['ms predict shipped']:.3f} / "
        f"{ref['ms predict shipped']:.3f}, serve "
        f"{ranks[0]['ms serve']:.3f} / {ref['ms serve']:.3f}; tables_ms per"
        f" rank {[round(o['tables_ms shipped'], 3) for o in ranks]} "
        f"(shipped), combine_ms {[round(o['combine_ms'], 3) for o in ranks]}"
        f"; launches K1 {k1}, K2 {k2}")
    if train_ref is not None:
        # the biases that feed a normalisation: gradient 0, rounding noise
        zero = {"VQVAE": set(),
                "PAE": {"conv1.bias", "conv2.bias", "deconv1.bias"} | {
                    f"fc.{i}.bias" for i in range(8)},
                "end2end": {f"WavEncoder.feat_extractor.{k}.bias"
                            for k in (0, 3, 6, 9)}}
        for name, (losses, grads) in ranks[0]["train"].items():
            want_losses, want_grads = train_ref[name]
            fed = zero.get(name) or {k for k in want_grads
                                     if k.endswith((".0.bias", ".3.bias"))}
            g_err = grads_err(grads, want_grads, fed)[0]
            tol, loss_tol, floor = TRAIN_GRAD_RTOL, TRAIN_LOSS_RTOL, 1e-12
            if name == "resync":
                tol, loss_tol = RESYNC_GRAD_RTOL, P20_RESYNC_LOSS_RTOL
                floor = 1.0
            err = max(abs(losses[k] - want_losses[k]) /
                      max(abs(want_losses[k]), floor) for k in losses)
            log(f"phase 20 [{world} {backend}] {name} data-parallel step "
                f"(batch {P20_TRAIN[name]}, {P20_TRAIN[name] // world} a "
                f"rank) vs one device: losses {losses} / {want_losses}, rel "
                f"{err:.3e} (tol {loss_tol}), gradients {g_err:.3e} (tol "
                f"{tol})")
            if err > loss_tol or g_err > tol:
                raise SystemExit(f"phase 20 {name}: the data-parallel step "
                                 "differs from one device's")
    return k1, k2


def torchrun(n: int, argv: list, env: dict = None) -> subprocess.Popen:
    """python -m torch.distributed.run --standalone --nproc-per-node n -m
    qpgesture_tpu_torch argv..., started (not waited for) from the
    checkout."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", "qpgesture_tpu_torch", *argv],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO, **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"phase 20 {name} exited {proc.returncode}:\n"
                         f"{out[-4000:]}")
    return out


def phase20(dev, rng, tmp: str, vq_cpu, data_mean, data_std) -> tuple:
    """Phase 20: database-sharded serving and data-parallel training in
    process groups on the one card (world 1 under NCCL; 2 and 4 gloo ranks
    sharing cuda:0), each rank held against the single device; match
    --sharded and train-vqvae under torch.distributed.run. Returns K1's,
    K2's, K3's and K7's launches (in the groups' ranks)."""
    import pickle
    import numpy as np
    import torch
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.schemas import (load_result, save_codes,
                                                  save_result, save_wavvq)
    from qpgesture_tpu_torch.models.wavlm import WavLM, WavLMConfig
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    from qpgesture_tpu_torch.motion.pipeline import MotionPipeline
    from qpgesture_tpu_torch.parallel.dist import spawn
    from qpgesture_tpu_torch.train.data import WindowedDataset
    p = lambda *names: os.path.join(tmp, *names)

    torch.manual_seed(SEED)
    enc_cpu = WavLM(WavLMConfig(), device="cpu")
    with torch.no_grad():   # a gate that is not ~constant, as in phase 7
        for name, prm in enc_cpu.named_parameters():
            if "grep_linear" in name:
                prm.mul_(8.0)
    ref, (bundle, codes, signature, wavvq, clips) = phase20_setup(
        dev, rng, tmp, enc_cpu, vq_cpu, data_mean, data_std)
    del enc_cpu
    with open(p("p20.pkl"), "rb") as f:
        train_inputs = pickle.load(f)["train"]
    t0 = time.time()
    train_ref = phase20_train_reference(dev, train_inputs, 2, tmp)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"phase 20 single-device training references: "
        f"{time.time() - t0:.1f} s")

    # the CLIs' files: the first P20_CLI_J sequences of the wavvq
    # database (the files are compressed), a cut train-vqvae set
    os.makedirs(p("cli"))
    n = P20_CLI_J
    dataclasses.replace(bundle, context=bundle.context[:n],
                        phase=bundle.phase[:n]).save(p("cli", "db.npz"))
    save_codes(p("cli", "codes.npz"), codes[:n])
    signature.save(p("cli", "code.npz"))
    save_wavvq(p("cli", "wavvq.npz"), wavvq[:n])
    save_wavvq(p("cli", "test_wavvq.npz"), clips[0][0])
    dataclasses.replace(bundle, context=clips[0][1],
                        phase=None).save(p("cli", "test.npz"))
    match = ["match", "--train-database", p("cli", "db.npz"),
             "--train-codebook", p("cli", "codes.npz"),
             "--codebook-signature", p("cli", "code.npz"),
             "--train-wavvq", p("cli", "wavvq.npz"),
             "--test-wavvq", p("cli", "test_wavvq.npz"),
             "--test-data", p("cli", "test.npz"), "--preset", "wavvq"]
    for name, n in (("train", P20_CLI_WINDOWS), ("val", TRAIN_BATCH)):
        WindowedDataset(poses=(rng.randn(n, 240, 135) * 0.5).astype(
            np.float32)).save(p("cli", name))
    write_train_config(p("cli", "train.yml"), val_data_path=p("cli", "val"))
    # the card every rank of every group runs on
    rank_dev = str(torch.device("cuda", torch.cuda.current_device())) \
        if dev.type == "cuda" else str(dev)
    k1 = k2 = k3 = k7 = 0
    for world, backend in P20_GROUPS:
        t1 = time.time()
        ranks = spawn(phase20_rank, world, (tmp, rank_dev, world == 2),
                      backend=backend)
        a, b = phase20_check(world, backend, ranks, ref,
                             train_ref if world == 2 else None)
        k1, k2 = k1 + a, k2 + b
        k3 += sum(o["k3"] for o in ranks)
        k7 += sum(o["k7"] for o in ranks)
        log(f"phase 20 [{world} {backend}] group: {time.time() - t1:.1f} s "
            f"wall (processes, staging, checks)")

    t0 = time.time()
    runs = {
        "match --sharded always (1 rank, nccl)": torchrun(
            1, match + ["--sharded", "always", "--out", p("cli", "a.npz")]),
        "match --sharded auto (2 gloo ranks on cuda:0)": torchrun(
            2, match + ["--sharded", "auto", "--out", p("cli", "b.npz"),
                        "--device", rank_dev, "--dist-backend", "gloo"],
            {"QPG_HBM_BYTES": "1"}),
        "train-vqvae (1 rank, nccl)": torchrun(
            1, ["train-vqvae", "--config", p("cli", "train.yml"), "--data",
                p("cli", "train"), "--out", p("cli", "vq"), "--epochs",
                "1"]),
    }
    outs = {name: finish(name, proc) for name, proc in runs.items()}
    cli(match + ["--sharded", "never", "--out", p("cli", "ref.npz")])
    want = load_result(p("cli", "ref.npz"))
    for name, path, n in (("always", "a.npz", 1), ("auto", "b.npz", 2)):
        text = outs[next(k for k in outs if f"--sharded {name}" in k)]
        if f"J axis over {n} rank(s)" not in text or \
                not np.array_equal(load_result(p("cli", path)), want):
            raise SystemExit(f"phase 20 match --sharded {name}: not sharded "
                             f"over {n} rank(s) or codes differ:\n"
                             f"{text[-2000:]}")
    pipe = MotionPipeline(fps=60).fit(parse_bvh(skeleton_bvh_text(rng)))
    with open(p("cli", "pipeline.json"), "w") as f:
        f.write(pipe.to_json())
    save_result(p("cli", "codes_in.npz"),
                rng.randint(0, 512, (2, 30)).astype(np.int32))
    cli(["decode", "--result", p("cli", "codes_in.npz"), "--checkpoint",
         p("cli", "vq"), "--pipeline", p("cli", "pipeline.json"),
         "--config", p("cli", "train.yml"), "--out", p("cli", "bvh"),
         "--prefix", "p20"])
    bvh = parse_bvh(p("cli", "bvh", "p20_generated.bvh"))
    if bvh.values.shape[0] != 2 * 240 or not np.isfinite(bvh.values).all():
        raise SystemExit(f"phase 20 decode of train-vqvae's checkpoint: "
                         f"{bvh.values.shape}")
    log(f"phase 20 torch.distributed.run: match --sharded always (1 rank, "
        f"NCCL) and --sharded auto (2 gloo ranks, QPG_HBM_BYTES=1: the "
        f"spill branch) == match --sharded never on J={P20_CLI_J}; "
        f"train-vqvae 1 epoch of "
        f"{P20_CLI_WINDOWS} windows (batch {TRAIN_BATCH}) -> rank 0's "
        f"best.pt decoded to BVH {bvh.values.shape}; {time.time() - t0:.1f}"
        f" s wall (the three launches at once)")
    return k1, k2, k3, k7


# Phase 21's budget (QPG_BENCH_BUDGET_S): room for every section, so that a
# section the budget skips fails the phase instead of shortening it.
P21_BUDGET_S = 900
# What each section of the bench's line must hold.
P21_KEYS = {
    ("wavvq",): ("gest_s_per_s", "p50_ms", "vs_baseline", "device",
                 "batched_16clip"),
    ("wavvq", "device"): ("device_ms", "tables_ms", "fuse_scan_ms",
                          "decode_ms", "lev_gcells_per_s", "idle_share"),
    ("wavvq", "batched_16clip"): ("gest_s_per_s", "device_ms",
                                  "gest_s_per_device_s"),
    ("wavlm",): ("gest_s_per_s", "p50_ms", "vs_baseline", "device"),
    ("wavlm", "device"): ("device_ms", "tables_ms", "fuse_scan_ms",
                          "decode_ms", "tflops_effective", "mfu_bf16_peak",
                          "tables_ms_high", "tables_ms_default",
                          "idle_share"),
    ("rawwav", "wavvq"): ("e2e_p50_ms", "device_ms", "enc_ms", "match_ms",
                          "gest_s_per_s", "mfu_bf16_peak"),
    ("rawwav", "wavlm_split:default"): ("e2e_p50_ms", "device_ms", "enc_ms",
                                        "match_ms", "gest_s_per_s",
                                        "mfu_bf16_peak"),
    ("train_vqvae",): ("step_ms_p50", "device_ms_per_step",
                       "windows_per_device_s", "mfu_bf16_peak",
                       "bf16_variant"),
    ("train_vqvae", "bf16_variant"): ("device_ms_per_step",
                                      "windows_per_device_s",
                                      "mfu_bf16_peak"),
    ("rawpose_knn_batch16",): ("p50_ms", "gest_s_per_s", "n_seqs"),
    ("pae_extract",): ("frames", "p50_ms", "frames_per_s"),
}


def walk(d, path=()):
    """(path, leaf) of every leaf of a nested dict / list."""
    if isinstance(d, dict):
        for k, v in d.items():
            yield from walk(v, path + (k,))
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from walk(v, path + (i,))
    else:
        yield path, d


def phase21_bench(kind: str) -> tuple:
    """Phase 21: the port's bench (qpgesture_tpu_torch/bench.py) in this
    process, at its own shapes with the default raw-wav modes, under a
    budget that fits every section. Its line must hold every section with
    its keys, no skipped / pending / error, finite numbers and the card's
    name; its wavvq request's codes must equal the CPU port's predict on
    the same staged data. Returns (compact line, K1 launches, K2
    launches, K7 launches)."""
    import numpy as np
    from qpgesture_tpu_torch import bench
    from qpgesture_tpu_torch.core.constants import POSE_DIM
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.ops import segmin_cuda as K7

    saved = {k: os.environ.get(k) for k in ("QPG_BENCH_BUDGET_S",
                                            "QPG_BENCH_RAWWAV_MODES")}
    os.environ["QPG_BENCH_BUDGET_S"] = str(P21_BUDGET_S)
    os.environ.pop("QPG_BENCH_RAWWAV_MODES", None)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            K1.launches = K2.launches = K7.launches = 0
            t0 = time.time()
            full = bench.main(["--full-out",
                               os.path.join(tmp, "bench_torch_full.json")])
            k1, k2, k7 = K1.launches, K2.launches, K7.launches
            bench_s = time.time() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    compact = bench._compact(full)
    line = json.dumps(compact)
    faults = [k for k in ("skipped", "pending") if k in full]
    faults += [p for p, _ in walk(full) if "error" in p]
    if full.get("value") is None or full["device_kind"] != kind:
        faults.append(f"value {full.get('value')}, device_kind "
                      f"{full.get('device_kind')!r}")
    for path, keys in P21_KEYS.items():
        sec = full
        for k in path:
            sec = sec.get(k, {}) if isinstance(sec, dict) else {}
        missing = [k for k in keys if k not in sec]
        if missing:
            faults.append(f"{'.'.join(path)} lacks {missing}")
    bad = [(p, x) for p, x in walk(compact)
           if isinstance(x, (int, float)) and not isinstance(x, bool)
           and not (np.isfinite(x) and x >= 0)]
    if bad:
        faults.append(f"numbers not finite or negative: {bad}")
    if faults:
        raise SystemExit(f"phase 21 bench: {faults}\n{line}")
    if not (k1 and k2 and k7):
        raise SystemExit(f"phase 21 launched K1 {k1}, K2 {k2}, K7 {k7} "
                         f"times")

    # the wavvq request's codes against the CPU port on the same data: the
    # bench's draws in order (the database, the decoder's codebook windows,
    # the wavvq mode's staging)
    rng = np.random.RandomState(0)
    bundle, codes, signature = bench._build_common(rng, bench.J)
    rng.randn(2, 240, POSE_DIM)
    _, _, engine, ta, tc = bench._stage_mode(
        "wavvq", rng, bench.J, bench.W, bundle, codes, signature,
        device="cpu")
    want = engine.predict(ta, tc, init_code=bench.INIT_CODE,
                          init_phase=np.zeros((8, 16), np.float32)).codes
    got = np.asarray(full["wavvq"]["codes"])
    if not np.array_equal(got, want):
        raise SystemExit(f"phase 21: the bench's wavvq codes differ from "
                         f"the CPU port's in {int((got != want).sum())} of "
                         f"{want.size}")
    log(f"phase 21 bench: {bench_s:.1f} s in bench.main, every section "
        f"with its keys; wavvq codes == CPU port ({want.shape}); launches "
        f"K1 {k1}, K2 {k2}, K7 {k7}")
    return line, k1, k2, k7


# -- phase 22: the port's examples (qpgesture_tpu_torch/examples/) ----------
P22_SOAK_FIXTURES = 5        # parity_soak fixtures a preset
P22_SWEEP_FIXTURES = 3       # chip_parity_sweep fixtures a preset
# the sweep below "highest" / float32: (cosine_precision, feat_dtype)
P22_SWEEPS = (("high", "float32"), ("default", "float32"),
              ("highest", "bfloat16"), ("highest", "float16"))
P22_TIE_FIXTURES = 40
# the scale study's sizes; wavlm's are cut from the top for the phase's
# budget: J=16384's host draw alone takes ~100 s, J=4096 ~46 s in all
# (python -m qpgesture_tpu_torch.examples.scale_study runs any size)
P22_SCALE = {"wavvq": (1024, 4096, 16384), "wavlm": (1024,)}
P22_SCALE_CPU_J = (1024, 16384)  # wavvq sizes whose codes the CPU checks
P22_STREAM_WINDOWS = 60
P22_POOL_TICKS = 20
P22_POOL_STREAMS = 16
P22_CAMPAIGN_EPOCHS, P22_CAMPAIGN_KILL, P22_CAMPAIGN_EVERY = 4, 2, 2
P22_CAMPAIGN_TIMEOUT_S = 600
P22_RAWWAV = (("wavlm", False), ("wavlm_split:default", True))
_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def reckoned_db_bytes(cfg, db) -> int:
    """The staged database's bytes from the host database's shapes: the
    audio features at the residency's width (int32 strings for wavvq), the
    text features in float32, the index tables (codes, blocks, window
    starts) in int64."""
    n = 0
    if cfg.use_aud:
        n += db.aud_strings.size * 4 if cfg.audio_mode == "wavvq_feat" \
            else db.aud_feat.size * _DTYPE_BYTES[cfg.feat_dtype]
        n += 8 * (db.aud_codes.size + db.aud_blocks.size
                  + len(db.aud_frames))
    if cfg.use_txt:
        n += db.txt_feat.size * 4
        n += 8 * (db.txt_codes.size + db.txt_blocks.size
                  + len(db.txt_frames))
    return n


def phase22_parity(dev: str) -> dict:
    """parity_soak (every preset x P22_SOAK_FIXTURES) and
    chip_parity_sweep at "highest" / float32 (with the gesture KNN and the
    long clip) on the card: 0 mismatches against the oracle, the long
    clip's codes equal to the CPU port's; then the sweep below "highest",
    its differing codes reported."""
    import numpy as np
    from qpgesture_tpu_torch.examples import chip_parity_sweep, parity_soak
    quiet = lambda s: None
    bad, rows = parity_soak.run(P22_SOAK_FIXTURES, dev, log=quiet)
    log(f"phase 22 parity_soak: {len(rows)} runs ({len(parity_soak.PRESETS)}"
        f" presets x {P22_SOAK_FIXTURES}), {bad} mismatches")
    if bad:
        raise SystemExit(f"phase 22 parity_soak: {bad} mismatches: "
                         f"{[r for r in rows if r['n_diff']]}")
    bad, rows = chip_parity_sweep.run(P22_SWEEP_FIXTURES, device=dev,
                                      log=quiet)
    long_row = rows[-1]
    cpu_codes, _ = chip_parity_sweep.long_clip_codes("cpu")
    gesture_err = max(r["max_abs_err"] for r in rows if "max_abs_err" in r)
    log(f"phase 22 chip_parity_sweep highest/float32: {len(rows)} runs, "
        f"{bad} mismatches; gesture KNN max_abs_err {gesture_err:.3e} (tol "
        f"{chip_parity_sweep.GESTURE_ATOL}); long clip "
        f"{long_row['codes'].shape} n_diff {long_row['n_diff']}, == CPU "
        f"port: {np.array_equal(long_row['codes'], cpu_codes)}")
    if bad or not np.array_equal(long_row["codes"], cpu_codes):
        raise SystemExit(f"phase 22 chip_parity_sweep: {bad} mismatches, "
                         f"long clip == CPU port: "
                         f"{np.array_equal(long_row['codes'], cpu_codes)}")
    diffs = {}
    for prec, fdt in P22_SWEEPS:
        n_bad, rows = chip_parity_sweep.run(P22_SWEEP_FIXTURES, prec, fdt,
                                            dev, log=quiet)
        key = f"{prec}/{fdt}"
        # a preset's fixture selects 2 windows x 30 codes
        diffs[key] = {"runs_mismatched": n_bad,
                      "codes_differing": sum(r.get("n_diff", 0)
                                             for r in rows),
                      "codes": sum(r["codes"].size if "codes" in r else 60
                                   for r in rows if "n_diff" in r)}
        log(f"phase 22 chip_parity_sweep {key}: {n_bad} runs mismatched, "
            f"{diffs[key]['codes_differing']} of {diffs[key]['codes']} codes "
            f"differ from the float32 oracle (reported, not gated)")
    return diffs


def phase22_ties(dev: str) -> dict:
    """tie_divergence_sweep on the card against the CPU port's on the same
    fixtures (one host: NumPy's introsort ties)."""
    from qpgesture_tpu_torch.examples import tie_divergence_sweep
    quiet = lambda s: None
    got = tie_divergence_sweep.main(P22_TIE_FIXTURES, dev, log=quiet)
    want = tie_divergence_sweep.main(P22_TIE_FIXTURES, "cpu", log=quiet)
    log(f"phase 22 tie_divergence_sweep: {json.dumps(got)}; == CPU port: "
        f"{got == want}")
    if got != want:
        raise SystemExit(f"phase 22 tie sweep: card {got} != CPU {want}")
    return got


def phase22_scale(dev: str, smi: str) -> list:
    """scale_study at P22_SCALE: one JSON line a size; the staged bytes
    against the shapes, resident bytes at least those, no error; wavvq
    codes at P22_SCALE_CPU_J against the CPU port on the same data."""
    import numpy as np
    import torch
    from qpgesture_tpu_torch.examples import scale_study
    from qpgesture_tpu_torch.match.engine import CodeKNNEngine
    from qpgesture_tpu_torch.utils import devtime
    _, peak = devtime.peak_flops_per_s()
    rows = []
    for mode, sizes in P22_SCALE.items():
        for J in sizes:
            keep = {}
            t0 = time.time()
            row = scale_study.run(mode, J, peak, device=dev, keep=keep)
            row["wall_s"] = round(time.time() - t0, 1)
            row["card"] = smi
            want = reckoned_db_bytes(keep["cfg"], keep["db"])
            check = ""
            if mode == "wavvq" and J in P22_SCALE_CPU_J:
                cpu = CodeKNNEngine(keep["cfg"], keep["db"], device="cpu")
                codes, _, _, _ = cpu.predict_device(
                    keep["test_audio"], keep["test_ctx"],
                    init_code=7, init_phase=np.zeros((8, 16), np.float32))
                same = np.array_equal(codes.numpy(), keep["codes"])
                check = f"; codes == CPU port: {same}"
                if not same:
                    raise SystemExit(f"phase 22 scale {mode} J={J}: card "
                                     f"codes differ from the CPU port's")
                del cpu
            log(f"phase 22 scale_study {json.dumps(row)}")
            log(f"phase 22 scale {mode} J={J}: db bytes {row['db_hbm_bytes']}"
                f" (reckoned from the shapes {want}), resident "
                f"{row['resident_bytes']}{check}")
            # the CPU reports no allocation: a rehearsal checks the bytes
            resident_ok = row["resident_bytes"] >= row["db_hbm_bytes"] \
                or dev == "cpu"
            if "error" in row or row["db_hbm_bytes"] != want or \
                    not resident_ok:
                raise SystemExit(f"phase 22 scale {mode} J={J}: {row}")
            rows.append(row)
            del keep
            torch.cuda.empty_cache()
    return rows


def phase22_streaming(dev: str) -> list:
    """streaming_soak: P22_STREAM_WINDOWS pushes of one stream and
    P22_POOL_TICKS ticks of P22_POOL_STREAMS streams, both presets; the
    soak's own assertions (pushes == whole clip, streams == solo)."""
    from qpgesture_tpu_torch.examples import streaming_soak
    rows = []
    for mode in ("wavvq", "wavlm"):
        rows.append(streaming_soak.soak(mode, P22_STREAM_WINDOWS,
                                        device=dev)[0])
        log(f"phase 22 streaming_soak {json.dumps(rows[-1])}")
    for mode in ("wavvq", "wavlm"):
        rows.append(streaming_soak.soak_pool(
            mode, P22_POOL_TICKS, P22_POOL_STREAMS, device=dev)[0])
        log(f"phase 22 streaming_soak pool {json.dumps(rows[-1])}")
    return rows


def phase22_serving(dev: str) -> None:
    """serve_production's four modes on the card (its bucketed clips held
    to solo predict inside), against the CPU port's codes."""
    import numpy as np
    from qpgesture_tpu_torch.examples import serve_production
    quiet = lambda s: None
    got = serve_production.main(dev, log=quiet)
    want = serve_production.main("cpu", log=quiet)
    same = all(np.array_equal(g, w) for k in ("single", "pool")
               for g, w in ((got[k], want[k]),)) and \
        all(np.array_equal(g, w) for k in ("bucketed", "batched")
            for g, w in zip(got[k], want[k]))
    log(f"phase 22 serve_production: single {got['single'].shape}, "
        f"bucketed {[c.shape for c in got['bucketed']]} == solo predict, "
        f"batched {len(got['batched'])} clips, pool {got['pool'].shape}; "
        f"== CPU port: {same}; seconds "
        f"{ {k: round(v, 4) for k, v in got['seconds'].items()} }")
    if not same:
        raise SystemExit("phase 22 serve_production: card codes differ from "
                         "the CPU port's")


def _campaign(out: str, *extra) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m",
           "qpgesture_tpu_torch.examples.train_campaign", "--out", out,
           "--epochs", str(P22_CAMPAIGN_EPOCHS), "--eval-every",
           str(P22_CAMPAIGN_EVERY), *extra]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=P22_CAMPAIGN_TIMEOUT_S)
    log(f"phase 22 train_campaign {' '.join(extra) or '(run)'}: exit "
        f"{proc.returncode} in {time.time() - t0:.1f} s")
    for line in proc.stdout.splitlines():
        log(f"    {line}")
    return proc


def phase22_campaign(tmp: str) -> dict:
    """train_campaign in subprocesses at the shipped width and its default
    corpus: killed after epoch P22_CAMPAIGN_KILL (exit 42), resumed to
    P22_CAMPAIGN_EPOCHS (exit 0) with every step counted, the checkpoints
    there and val_err falling; then --post-eval."""
    out = os.path.join(tmp, "campaign")
    proc = _campaign(out, "--stop-after", str(P22_CAMPAIGN_KILL))
    if proc.returncode != 42:
        raise SystemExit(f"phase 22 campaign kill: exit {proc.returncode}\n"
                         f"{proc.stderr[-3000:]}")
    proc = _campaign(out, "--resume")
    if proc.returncode != 0:
        raise SystemExit(f"phase 22 campaign resume: exit {proc.returncode}"
                         f"\n{proc.stderr[-3000:]}")
    with open(os.path.join(out, "campaign_report.json")) as f:
        report = json.load(f)
    spe = report["steps_per_epoch"]
    epochs = [r["epoch"] for r in report["epochs_run"]]
    val = [r["val_err"] for r in report["epochs_run"]]
    files = sorted(os.listdir(out))
    want_files = ["002.pt", "004.pt", "best.pt", "latest.pt"]
    log(f"phase 22 campaign: {report['windows_total']} windows, {spe} steps "
        f"an epoch, total_steps {report['total_steps']}, epochs {epochs}, "
        f"val_err {val}, windows/s "
        f"{[r['windows_per_s'] for r in report['epochs_run']]}, files "
        f"{files}")
    if report["total_steps"] != P22_CAMPAIGN_EPOCHS * spe or \
            epochs != list(range(1, P22_CAMPAIGN_EPOCHS + 1)) or \
            not set(want_files) <= set(files) or not val[-1] < val[0]:
        raise SystemExit(f"phase 22 campaign: {report}")
    proc = _campaign(out, "--post-eval")
    with open(os.path.join(out, "self_eval.json")) as f:
        rows = json.load(f)
    if proc.returncode != 0 or [r["checkpoint"] for r in rows] != \
            ["002", "004", "best"]:
        raise SystemExit(f"phase 22 campaign post-eval: exit "
                         f"{proc.returncode}, rows {rows}\n"
                         f"{proc.stderr[-3000:]}")
    return report


def phase22_demo(dev: str, tmp: str) -> None:
    """demo_synthetic on the card: its BVH parses with windows x 240
    frames."""
    import numpy as np
    from qpgesture_tpu_torch.examples import demo_synthetic
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    out = demo_synthetic.main(os.path.join(tmp, "demo"), dev,
                              log=lambda s: None)
    bvh = parse_bvh(out["bvh"])
    log(f"phase 22 demo_synthetic: codes {out['codes'].shape}, BVH "
        f"{bvh.values.shape} parsed back")
    if bvh.values.shape[0] != out["n_windows"] * 240 or \
            not np.isfinite(bvh.values).all():
        raise SystemExit(f"phase 22 demo: BVH {bvh.values.shape}, "
                         f"{out['n_windows']} windows")


def phase22_rawwav(dev: str) -> list:
    """rawwav_latency: WavLM-Large at "highest" (float32 K2) and at
    "default" (bfloat16 K2) with its index agreement against "highest"."""
    from qpgesture_tpu_torch.examples import rawwav_latency
    rows = []
    for mode, parity in P22_RAWWAV:
        rows.append(rawwav_latency.run(mode, dev, parity=parity))
        log(f"phase 22 rawwav_latency {json.dumps(rows[-1])}")
    return rows


def phase22_examples(dev: str, smi: str) -> tuple:
    """Phase 22: every example of the port on ``dev`` (the card; a CPU
    rehearsal passes "cpu", shrinks the P22_* constants, replaces
    phase22_campaign, whose CPU run tests/test_torch_examples.py makes at
    a small width, and sees no launches). Returns (K1 launches, K2
    launches, K7 launches)."""
    from qpgesture_tpu_torch.ops import flash_attention_cuda as K2
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.ops import segmin_cuda as K7
    import torch
    t0 = time.time()
    K1.launches = K2.launches = K7.launches = 0
    walls = {}

    def part(name, fn, *args):
        t = time.time()
        out = fn(*args)
        walls[name] = round(time.time() - t, 1)
        torch.cuda.empty_cache()
        return out

    part("parity", phase22_parity, dev)
    part("ties", phase22_ties, dev)
    part("scale", phase22_scale, dev, smi)
    part("streaming", phase22_streaming, dev)
    part("serving", phase22_serving, dev)
    with tempfile.TemporaryDirectory() as tmp:
        part("campaign", phase22_campaign, tmp)
        part("demo", phase22_demo, dev, tmp)
    part("rawwav", phase22_rawwav, dev)
    k1, k2, k7 = K1.launches, K2.launches, K7.launches
    log(f"phase 22 launches: K1 {k1}, K2 {k2}, K7 {k7}; walls "
        f"{json.dumps(walls)}; {time.time() - t0:.1f} s in all")
    if not (k1 and k2):
        raise SystemExit(f"phase 22 launched K1 {k1}, K2 {k2} times")
    return k1, k2, k7


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
    from qpgesture_tpu_torch.ops import fusion_scan_cuda as K3
    from qpgesture_tpu_torch.ops import groupnorm_cuda as K5
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.ops import posconv_cuda as K6
    from qpgesture_tpu_torch.ops import relkey_attention_cuda as K4
    from qpgesture_tpu_torch.ops import segmin_cuda as K7
    from qpgesture_tpu_torch.serve import ServingPipeline
    k3_launches = k5_launches = k6_launches = k7_launches = 0

    def k3_read(phase: str, elsewhere: int = 0) -> None:
        """Adds K3's launches since its counter was set to 0 (and those
        counted in other processes) to the total, sets it to 0 for the next
        phase, and exits when the phase, which scans on the card, ran no
        K3."""
        nonlocal k3_launches
        n, K3.launches = K3.launches + elsewhere, 0
        log(f"{phase} K3 launches {n}")
        if n == 0:
            raise SystemExit(f"{phase} scanned without the fusion scan "
                             f"kernel (K3)")
        k3_launches += n

    def k5_read(phase: str) -> None:
        """Adds K5's launches since its counter was set to 0, just before
        the phase's vq-wav2vec work on the main path, to the total, and
        exits when that work ran no K5."""
        nonlocal k5_launches
        n, K5.launches = K5.launches, 0
        log(f"{phase} K5 launches {n}")
        if n == 0:
            raise SystemExit(f"{phase} ran vq-wav2vec without the GroupNorm "
                             f"kernel (K5)")
        k5_launches += n

    def k6_read(phase: str) -> None:
        """Adds K6's launches since its counter was set to 0, just before
        the phase's WavLM work at "highest" on the card, to the total, and
        exits when that work ran no K6."""
        nonlocal k6_launches
        n, K6.launches = K6.launches, 0
        log(f"{phase} K6 launches {n}")
        if n == 0:
            raise SystemExit(f"{phase} ran WavLM at \"highest\" without the "
                             f"positional conv kernel (K6)")
        k6_launches += n

    def k7_read(phase: str, n: int = None) -> None:
        """Adds K7's launches since its counter was set to 0, just before
        the phase's work on the main path (timing and check loops run
        ``uncounted``), or the n counted in other processes, to the total,
        sets the counter to 0, and exits when that work, which builds its
        tables on the card, ran no K7."""
        nonlocal k7_launches
        n, K7.launches = K7.launches if n is None else n, 0
        log(f"{phase} K7 launches {n}")
        if n == 0:
            raise SystemExit(f"{phase} built its tables on the card without "
                             f"the per-code reduction kernel (K7)")
        k7_launches += n

    # -- phase 2: build, one nvcc per source, all at once -------------------
    t0 = time.time()
    cuda_build.build_all([K1.SOURCE, K2.SOURCE, K3.SOURCE, K4.SOURCE,
                          K5.SOURCE, K6.SOURCE, K7.SOURCE])
    log(f"phase 2 build: {K1.SOURCE} + {K2.SOURCE} + {K3.SOURCE} + "
        f"{K4.SOURCE} + {K5.SOURCE} + {K6.SOURCE} + {K7.SOURCE} "
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

    K1.launches = K2.launches = K3.launches = K7.launches = 0
    served, req_ms = [], []
    for r in range(N_REQUESTS):
        before, before3, before7 = K1.launches, K3.launches, K7.launches
        t0 = time.perf_counter()
        out = serving.serve(*requests[r])   # returns host arrays: synced
        req_ms.append(1e3 * (time.perf_counter() - t0))
        if K1.launches <= before:
            raise SystemExit(f"request {r} did not launch K1")
        if K3.launches != before3 + 1:
            raise SystemExit(f"request {r} launched K3 "
                             f"{K3.launches - before3} times, not once")
        # a K7 call is two launches (the pass and the decode), one call a
        # side
        if K7.launches != before7 + 4:
            raise SystemExit(f"request {r} launched K7 "
                             f"{K7.launches - before7} times, not 4 (two "
                             f"calls, one a side)")
        served.append(out)
    k1_launches = K1.launches
    from qpgesture_tpu_torch.utils import profiling
    with profiling.recording() as prof:
        serving.serve(*requests[0])
    counted = [rec["counters"].get("segmin_kernel")
               for rec in prof.take() if rec["name"] == "tables"]
    log(f"phase 4 tables spans' segmin_kernel under the recorder: {counted}")
    if counted != [2]:
        raise SystemExit(f"phase 4: a request's tables span counted "
                         f"segmin_kernel {counted}, not [2]")
    k7_read("phase 4")

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
    with uncounted():
        tables_ms = median_ms(tables, 10)
    scan_ms = median_ms(scan, 5, warmup=1)
    decode_ms = median_ms(lambda: model_gpu.decode(codes_flat), 10)
    log(f"phase 4 stage times: tables_ms={tables_ms:.4f} "
        f"scan_ms={scan_ms:.4f} decode_ms={decode_ms:.4f}")
    log_profile("phase 4", lambda: serving.serve(*requests[0]))
    k3_read("phase 4")
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
        K7.launches = 0
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

    k7_read("phase 5")
    k3_read("phase 5")
    phase_wall("phase 5")

    # -- phase 6: K2 against its plain version on the card ------------------
    k2_line = phase_k2(dev)
    phase_wall("phase 6")
    K3.launches = 0                 # phase 6 does not scan

    # -- phase 6b: K4 and raw-wav serving with w2v-BERT 2.0 ----------------
    K4.launches = K7.launches = 0
    k4_line = phase_k4(dev, np.random.RandomState(SEED + 6), bundle, codes,
                       signature, model_gpu, data_mean, data_std)
    k4_launches, K4.launches = K4.launches, 0
    log(f"phase 6b K4 launches {k4_launches}")
    if k4_launches == 0:
        raise SystemExit("phase 6b encoded with w2v-BERT without K4")
    k7_read("phase 6b")
    k3_read("phase 6b")
    phase_wall("phase 6b")

    # -- phase 6c: K5, vq-wav2vec's GroupNorm + activation -----------------
    K5.launches = 0
    k5_line = phase_k5(dev)
    log(f"phase 6c K5 launches {K5.launches} (checks and timings, left out "
        f"of the kernels line's count)")
    if K5.launches == 0:
        raise SystemExit("phase 6c ran no K5")
    torch.cuda.empty_cache()
    phase_wall("phase 6c")

    # -- phase 6d: K6, WavLM's positional conv + GELU + residual -----------
    K6.launches = 0
    k6_line = phase_k6(dev)
    log(f"phase 6d K6 launches {K6.launches} (checks and timings, left out "
        f"of the kernels line's count)")
    if K6.launches == 0:
        raise SystemExit("phase 6d ran no K6")
    torch.cuda.empty_cache()
    phase_wall("phase 6d")

    # -- phase 6e: bias-free K2 and raw-wav serving with Whisper ----------
    K7.launches = 0
    nobias_line, nobias_launches = phase_nobias(
        dev, np.random.RandomState(SEED + 7), bundle, codes, signature,
        model_gpu, data_mean, data_std)
    if nobias_launches == 0:
        raise SystemExit("phase 6e encoded with Whisper without the "
                         "bias-free K2")
    k7_read("phase 6e")
    k3_read("phase 6e")
    phase_wall("phase 6e")

    # -- phase 6f: K7, the per-code candidate reduction ---------------------
    K7.launches = 0
    k7_line = phase_k7(dev)
    log(f"phase 6f K7 launches {K7.launches} (checks and timings, left out "
        f"of the kernels line's count)")
    if K7.launches == 0:
        raise SystemExit("phase 6f ran no K7")
    torch.cuda.empty_cache()
    phase_wall("phase 6f")

    # -- phase 7: raw-wav serving, shipped preset, WavLM-Large --------------
    K6.launches = K7.launches = 0
    k2_launches, shipped = phase_rawwav_shipped(
        dev, rng, bundle, codes, signature, model_gpu, model_cpu,
        data_mean, data_std)
    k6_read("phase 7")
    k7_read("phase 7")
    k3_read("phase 7")
    phase_wall("phase 7")

    # -- phase 8: the same at precision="default" (bfloat16 K2) -----------
    K7.launches = 0
    k2_launches += phase_rawwav_default(dev, shipped, model_gpu, data_mean,
                                        data_std)
    k7_read("phase 8")
    k3_read("phase 8")
    phase_wall("phase 8")

    # -- phase 9: raw-wav serving, wavvq preset -----------------------------
    K5.launches = K7.launches = 0
    k1_launches += phase_rawwav_wavvq(dev, rng, serving, db, cfg)
    k5_read("phase 9")
    k7_read("phase 9")
    k3_read("phase 9")
    phase_wall("phase 9")

    # -- phase 10: generate CLI ----------------------------------------------
    K6.launches = K7.launches = 0
    phase_generate(rng, bundle, codes, signature, shipped["feats_db"],
                   shipped["enc_cpu"], model_cpu)
    k6_read("phase 10")
    k7_read("phase 10")
    k3_read("phase 10")
    phase_wall("phase 10")

    # -- phase 11: batched serving ------------------------------------------
    K6.launches = K7.launches = 0
    k1, k2, staged = phase_batch(dev, rng, serving, db, cfg, shipped,
                                 model_gpu, data_mean, data_std)
    k6_read("phase 11")
    k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
    k7_read("phase 11")
    k3_read("phase 11")
    phase_wall("phase 11")

    # -- phase 12: streaming pools and sessions -----------------------------
    K6.launches = K7.launches = 0
    k1, k2 = phase_streaming(dev, serving, staged)
    k6_read("phase 12")
    k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
    k7_read("phase 12")
    k3_read("phase 12")
    phase_wall("phase 12")

    # -- phase 13: the shipped preset at precision="high" --------------------
    K7.launches = 0
    k2_launches += phase_high(dev, shipped, model_gpu, data_mean, data_std)
    k7_read("phase 13")
    k3_read("phase 13")
    phase_wall("phase 13")

    # -- phase 14: transcript -> MiniLM -> context ingress ------------------
    K6.launches = K7.launches = 0
    k2_launches += phase_transcript(dev, rng, shipped, staged["server"])
    k6_read("phase 14")
    del staged
    k7_read("phase 14")
    k3_read("phase 14")
    phase_wall("phase 14")

    # -- phase 15: database build on the card -> serve, and the CLIs -------
    k2_b8 = k2_times(dev, 8)
    with tempfile.TemporaryDirectory() as tmp:
        K1.launches = K2.launches = K5.launches = K6.launches = 0
        K7.launches = 0
        built = phase_build(dev, rng, shipped, model_cpu, tmp)
        phase_build_clis(dev, built, shipped["enc_cpu"], tmp)
        k1, k2 = K1.launches, K2.launches
        k5_read("phase 15")
        k6_read("phase 15")
    log(f"phase 15 K2 at B=8 (extract_wavlm's batch), f32: kernel_ms="
        f"{k2_b8['ms']:.5f} library_ms={k2_b8['library_ms']:.5f} (SDPA) "
        f"bound_ms={k2_b8['bound_ms']:.5f} ({k2_b8['bound_by']}); phase 15 "
        f"launches: K1 {k1}, K2 {k2}")
    if not (k1 and k2):
        raise SystemExit("phase 15 did not launch both kernels")
    k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
    k7_read("phase 15")
    k3_read("phase 15")
    phase_wall("phase 15")

    # -- phase 16: matching surface and generate extras --------------------
    with tempfile.TemporaryDirectory() as tmp:
        K1.launches = K2.launches = K6.launches = K7.launches = 0
        phase16_tables(dev, shipped, model_gpu, data_mean, data_std)
        k6_read("phase 16")
        phase16_reference_ties(dev, serving, reference, requests, bundle,
                               codes, signature, wavvq)
        phase16_release(tmp, bundle, codes, signature, wavvq, clips,
                        model_cpu)
        phase16_resync_end2end(dev, rng, tmp, model_cpu)
        k1, k2 = K1.launches, K2.launches
    log(f"phase 16 launches: K1 {k1}, K2 {k2}")
    if not (k1 and k2):
        raise SystemExit("phase 16 did not launch both kernels")
    k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
    k7_read("phase 16")
    k3_read("phase 16")
    phase_wall("phase 16")

    # -- phase 16b: the fusion scan kernel against its plain loop ----------
    k3_times = phase16b_scan(dev, serving, requests, shipped, smi)
    del shipped
    torch.cuda.empty_cache()
    log(f"phase 16b K7 launches {K7.launches} (the tables of K3's checks, "
        f"left out of the kernels line's count)")
    K7.launches = 0
    k3_read("phase 16b")
    phase_wall("phase 16b")

    # -- phase 17: training on the card -> the trained models served -------
    with tempfile.TemporaryDirectory() as tmp:
        K1.launches = K2.launches = K7.launches = 0
        vq_out = phase17_vqvae(dev, rng, tmp, built["pipeline"])
        torch.cuda.empty_cache()
        pae_card = phase17_pae(dev, tmp)
        phase17_end2end(dev, rng, tmp, vq_out)
        K5.launches = 0
        phase17_serve(dev, built, vq_out, pae_card)
        k5_read("phase 17")
        k1, k2 = K1.launches, K2.launches
        log(f"phase 17 launches: K1 {k1}, K2 {k2} (WavLM is not on this "
            f"path)")
        if not k1:
            raise SystemExit("phase 17 did not launch K1")
        k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
        del pae_card
        torch.cuda.empty_cache()
        k7_read("phase 17")
        k3_read("phase 17")
        phase_wall("phase 17")

        # -- phase 18: resync training, evaluation, raw-pose search --------
        K1.launches = K2.launches = K5.launches = K7.launches = 0
        phase18_rawpose(dev, rng, built, tmp)
        data, fake = phase18_resync_data(built, tmp)
        resync_dir = phase18_train_resync(dev, data, tmp)
        torch.cuda.empty_cache()
        generated = phase18_serve(dev, built, tmp, resync_dir, fake)
        phase18_evaluate(dev, built, tmp, vq_out, generated)
        phase18_mfcc(dev, built)
        k1, k2 = K1.launches, K2.launches
        k5_read("phase 18")
        log(f"phase 18 launches: K1 {k1} (warmup's bucket, generate "
            f"--resync and its library check), K2 {k2} (WavLM is not on "
            f"this path)")
        if not k1:
            raise SystemExit("phase 18 did not launch K1")
        k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
        torch.cuda.empty_cache()
        k7_read("phase 18")
        k3_read("phase 18")
        phase_wall("phase 18")

        # -- phase 19: the rest of the single-GPU surface ------------------
        K1.launches = K2.launches = K7.launches = 0
        phase19_vqvae_steps(dev, rng)
        torch.cuda.empty_cache()
        codes19, sig19, _ = phase19_vqvae_serve(dev, built, tmp)
        phase19_analytics(codes19, sig19)
        phase19_simple_vqvae(dev, rng)
        torch.cuda.empty_cache()
        phase19_seq2seq(dev, rng)
        phase19_trinity(dev, rng, tmp)
        k1, k2 = K1.launches, K2.launches
        log(f"phase 19 launches: K1 {k1} (the wavvq request on the "
            f"\"default\" codes), K2 {k2} (WavLM is not on this path)")
        if not k1:
            raise SystemExit("phase 19 did not launch K1")
        k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
    del built
    k7_read("phase 19")
    k3_read("phase 19")
    phase_wall("phase 19")

    # -- phase 20: process groups: sharded serving, data-parallel training -
    with tempfile.TemporaryDirectory() as tmp:
        k1, k2, k3, k7 = phase20(dev, rng, tmp, model_cpu, data_mean,
                                 data_std)
    log(f"phase 20 launches (in the groups' ranks): K1 {k1}, K2 {k2}, K3 "
        f"{k3}, K7 {k7}")
    if not (k1 and k2 and k3):
        raise SystemExit("phase 20 did not launch K1, K2 and K3")
    k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
    K7.launches = 0     # this process's single-device references
    k7_read("phase 20", k7)
    k3_read("phase 20", elsewhere=k3)
    phase_wall("phase 20")

    # -- phase 21: the port's bench ------------------------------------------
    K5.launches = 0
    bench_line, k1, k2, k7 = phase21_bench(kind)
    k5_read("phase 21")
    k7_read("phase 21", k7)
    k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
    k3_read("phase 21")
    phase_wall("phase 21")

    # -- phase 22: the port's examples ---------------------------------------
    K6.launches = 0
    k1, k2, k7 = phase22_examples("cuda", smi)
    k6_read("phase 22")
    k7_read("phase 22", k7)
    k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
    k3_read("phase 22")
    phase_wall("phase 22")

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
    }, {
        "name": "fusion_scan",
        "route": "cuda",
        "source": "qpgesture_tpu_torch/csrc/fusion_scan.cu",
        "replaces": "none: the lax.scan of qpgesture_tpu/match/engine.py:750",
        "launches": k3_launches,
        **k3_times,
    }, {
        "name": "relkey_attention",
        "route": "cuda",
        "source": "qpgesture_tpu_torch/csrc/relkey_attention.cu",
        "replaces": "none: the JAX package has no w2v-BERT",
        "launches": k4_launches,
        **k4_line,
    }, {
        "name": "groupnorm1",
        "route": "cuda",
        "source": "qpgesture_tpu_torch/csrc/groupnorm1_act.cu",
        "replaces": "none: jnp in qpgesture_tpu/models/vq_wav2vec.py:77-79",
        "launches": k5_launches,
        **k5_line,
    }, {
        "name": "posconv",
        "route": "cuda",
        "source": "qpgesture_tpu_torch/csrc/posconv.cu",
        "replaces": "none: XLA's conv in qpgesture_tpu/models/wavlm.py:288-295",
        "launches": k6_launches,
        **k6_line,
    }, {
        "name": "segmin",
        "route": "cuda",
        "source": "qpgesture_tpu_torch/csrc/segmin.cu",
        "replaces": "none: jax.ops.segment_min in "
                    "qpgesture_tpu/match/engine.py:89-109",
        "launches": k7_launches,
        **k7_line,
    }, {
        "name": "nobias_flash_attention",
        "route": "cuda",
        "source": "qpgesture_tpu_torch/csrc/flash_attention.cu",
        "replaces": "none: the JAX package has no Whisper",
        "launches": nobias_launches,
        **nobias_line,
    }]}
    log(f"total {time.time() - t_start:.1f} s")
    print(bench_line)
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
