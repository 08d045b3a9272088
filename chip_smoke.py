#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds every CUDA kernel of the port from the sources in the checkout,
holds each against its plain PyTorch version on the card, drives the main
serving path (wavvq preset, full-width default VQ-VAE, J=1024 database,
3 requests of 6 windows = 24 s clips) and the match -> decode CLI, and
prints one line per phase. The last three lines are the card's name and
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
POSE_ATOL = 1e-3   # card vs CPU poses: float32 decode, other sum orders
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# 32-bit ALU operations an SM issues per clock: 4 schedulers x 32 lanes,
# the rate behind the data sheet's 67 TFLOP/s float32 (an FMA counted as
# two). K1 runs above the 64/clock of the integer-only units on the
# whole-corpus shape, so this is the peak its operations are held to.
ALU_OPS_PER_SM_CLOCK = 128


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


def skeleton_bvh_text(rng, n_frames: int = 48, fps: int = 120) -> str:
    """A BEAT-like skeleton holding the 15 upper-body target joints under a
    Hips root, with random motion."""
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
    for row in rng.uniform(-30, 30, size=(n_frames, n_ch)):
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
    t_start = time.time()

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
    from qpgesture_tpu_torch.ops import levenshtein_cuda as K1
    from qpgesture_tpu_torch.serve import ServingPipeline

    # -- phase 2: build ----------------------------------------------------
    t0 = time.time()
    K1.build()
    log(f"phase 2 build: levenshtein.cu {time.time() - t0:.2f} s")

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
    kernel_ms = median_ms(lambda: K1.levenshtein_matrix(q_main, b_main), 50)
    plain_ms = median_ms(lambda: K1.levenshtein_matrix_plain(q_main, b_main),
                         5, warmup=1)
    bound_ms, bound_by = lev_bound(Q, N, 11, props.multi_processor_count,
                                   sm_clock_hz)
    log(f"phase 3 K1 times at Q={Q} N={N}: kernel_ms={kernel_ms:.5f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})")
    b_corpus = cases[-1][2]
    corpus_ms = median_ms(lambda: K1.levenshtein_matrix(q_main, b_corpus), 20)
    corpus_bound, _ = lev_bound(Q, b_corpus.shape[0], 11,
                                props.multi_processor_count, sm_clock_hz)
    log(f"phase 3 K1 times at Q={Q} N={b_corpus.shape[0]}: "
        f"kernel_ms={corpus_ms:.5f} bound_ms={corpus_bound:.5f}")

    # -- phase 4: main path ------------------------------------------------
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

    K1.launches = 0
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
        return eng._fuse_scan(cfg, S, engine.dev, state["t"], 0, None, None,
                              np.eye(1, W * S, dtype=bool)[0],
                              np.zeros(W * S, np.int32),
                              np.zeros((W * S, 8, 16), np.float32))

    codes_flat = torch.as_tensor(served[0][0].reshape(1, -1), device=dev)
    tables_ms = median_ms(tables, 10)
    scan_ms = median_ms(scan, 5, warmup=1)
    decode_ms = median_ms(lambda: model_gpu.decode(codes_flat), 10)
    log(f"phase 4 stage times: tables_ms={tables_ms:.4f} "
        f"scan_ms={scan_ms:.4f} decode_ms={decode_ms:.4f}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serving.serve(*requests[0])
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"phase 4 profile: device busy {busy_us / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms wall (idle share "
        f"{1 - busy_us / wall_us:.3f}); top kernels:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:9.4f} ms x{e.count:5d} "
            f"{e.key[:90]}")

    # -- phase 5: match -> decode CLI --------------------------------------
    from qpgesture_tpu_torch.cli import main as cli
    from qpgesture_tpu_torch.core.schemas import (load_result, save_codes,
                                                  save_wavvq)
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    from qpgesture_tpu_torch.motion.pipeline import MotionPipeline
    with tempfile.TemporaryDirectory() as tmp:
        p = lambda name: os.path.join(tmp, name)
        bundle.save(p("db.npz"))
        save_codes(p("codes.npz"), codes)
        signature.save(p("code.npz"))
        save_wavvq(p("wavvq.npz"), wavvq)
        save_wavvq(p("test_wavvq.npz"), clips[0][0])
        dataclasses.replace(bundle, context=clips[0][1],
                            phase=None).save(p("test.npz"))
        torch.save({"model_dict": model_cpu.state_dict()}, p("vqvae.bin"))
        pipe = MotionPipeline(fps=60).fit(parse_bvh(skeleton_bvh_text(rng)))
        with open(p("pipeline.json"), "w") as f:
            f.write(pipe.to_json())
        t0 = time.time()
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
            f"{bvh.values.shape} parsed back, {time.time() - t0:.2f} s")

    # -- phase 6: the kernels line and the result --------------------------
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
