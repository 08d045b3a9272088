"""Streaming-serving soak: steady-state latency of window-at-a-time
matching with the seeds kept on the device (serve.StreamingSession), and
the multi-stream pool (serve.StreamingPool).

Simulates a live-audio client: one 4 s window arrives at a time; each push
uploads that window's staged features and downloads 30 codes. Reports
p50 / p95 per push (after two warm-up pushes) and the first push for the
wavvq (K1) and shipped (wavlm) presets against a speaker-10-scale database
(J=1024), whose codes must equal a whole-clip ``predict``; then 16
concurrent streams advanced one window per tick through one lane-batched
scan, every stream's first 4 windows held bit-equal to a solo session.

    python -m qpgesture_tpu_torch.examples.streaming_soak [n_windows]
        [--device cuda|cpu]

The data are the JAX example's: ``RandomState(0)`` (solo) and ``(1)``
(pool) in its draw order, per-window seeds 1000 + 97 i + w (audio) and
5000 + 97 i + w (context).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .. import bench
from ..core import constants as C
from ..core.config import MATCH_PRESETS
from ..match.database import (stage_database, stage_test_audio,
                              stage_test_context)
from ..match.engine import CodeKNNEngine
from ..serve import StreamingPool, StreamingSession

J_DB = 1024  # speaker-10 scale


def _database(mode: str, rng, J: int):
    """(cfg, db, draw_audio): the mode's preset and host-staged database
    drawn from ``rng``; draw_audio(rng, n) draws n windows of test audio
    as the database's were drawn."""
    bundle, codes, signature = bench._build_common(rng, J)
    if mode == "wavvq":
        cfg = MATCH_PRESETS["wavvq"]

        def draw_audio(r, n):
            return r.randint(0, C.WAVVQ_VOCAB, size=(n, C.WAVVQ_FRAMES, 2)
                             ).astype(np.int32)
        db = stage_database(cfg, bundle, codes, signature,
                            wavvq=draw_audio(rng, J))
    else:
        cfg = MATCH_PRESETS["shipped"]

        def draw_audio(r, n):
            return bench.randn_f32(r, n, C.WAVLM_FRAMES, 1024)
        db = stage_database(cfg, bundle, codes, signature,
                            wavlm=draw_audio(rng, J))
    return cfg, db, draw_audio


def _stage_audio(cfg, db, mode: str, audio: np.ndarray) -> np.ndarray:
    key = "wavvq" if mode == "wavvq" else "wavlm"
    return stage_test_audio(cfg, db, **{key: audio})


def soak(mode: str, n_windows: int, J: int = J_DB, device="cuda"):
    """One live stream of max(4, n_windows) windows. Returns (row, codes
    (W, 30)); raises if the pushes' codes differ from the whole clip's."""
    rng = np.random.RandomState(0)
    W = max(4, n_windows)
    cfg, db, draw_audio = _database(mode, rng, J)
    ta = _stage_audio(cfg, db, mode, draw_audio(rng, W))
    tc = stage_test_context(db, rng.randn(W, 30, C.CONTEXT_DIM)
                            .astype(np.float32))

    engine = CodeKNNEngine(cfg, db, device=device)
    want = engine.predict(ta, tc, rng=np.random.RandomState(cfg.seed)).codes

    sess = StreamingSession(engine, rng=np.random.RandomState(cfg.seed))
    times = []
    got = []
    for w in range(W):
        t0 = time.perf_counter()
        got.append(sess.push_window(ta[w], tc[w]))
        times.append(time.perf_counter() - t0)
    got = np.stack(got)
    if not (got == want).all():
        raise AssertionError(f"{mode}: streaming diverged from predict in "
                             f"{int((got != want).sum())} codes")
    steady = times[2:]  # after the kernels' build and the first launches
    return {
        "mode": mode, "windows": W, "J": J,
        "p50_ms": round(float(np.percentile(steady, 50)) * 1e3, 3),
        "p95_ms": round(float(np.percentile(steady, 95)) * 1e3, 3),
        "first_push_ms": round(times[0] * 1e3, 2),
        "bit_equal_to_whole_clip": True,
    }, got


def soak_pool(mode: str, n_windows: int, n_streams: int = 16,
              J: int = J_DB, device="cuda"):
    """n_streams live streams, one tick per window for max(4, n_windows)
    ticks. Returns (row, codes (ticks, n_streams, 30)); raises if a
    stream's first 4 windows differ from its solo session's."""
    rng = np.random.RandomState(1)
    W = max(4, n_windows)
    cfg, db, draw_audio = _database(mode, rng, J)

    def window(i, w):
        r = np.random.RandomState(1000 + 97 * i + w)
        return _stage_audio(cfg, db, mode, draw_audio(r, 1))[0]

    def ctx_window(i, w):
        r = np.random.RandomState(5000 + 97 * i + w)
        return stage_test_context(
            db, r.randn(1, 30, C.CONTEXT_DIM).astype(np.float32))[0]

    engine = CodeKNNEngine(cfg, db, device=device)
    pool = StreamingPool(engine, n_streams,
                         rngs=[np.random.RandomState(cfg.seed + i)
                               for i in range(n_streams)])
    times = []
    pool_codes = []
    for w in range(W):
        ta = np.stack([window(i, w) for i in range(n_streams)])
        tc = np.stack([ctx_window(i, w) for i in range(n_streams)])
        t0 = time.perf_counter()
        pool_codes.append(pool.tick(ta, tc))
        times.append(time.perf_counter() - t0)

    for i in range(n_streams):
        sess = StreamingSession(engine,
                                rng=np.random.RandomState(cfg.seed + i))
        for w in range(min(4, W)):
            got = sess.push_window(window(i, w), ctx_window(i, w))
            if not (got == pool_codes[w][i]).all():
                raise AssertionError(f"{mode}: stream {i} window {w} "
                                     f"diverged from its solo session")

    steady = times[2:]
    p50 = float(np.percentile(steady, 50))
    return {
        "mode": mode, "streams": n_streams, "windows": W, "J": J,
        "tick_p50_ms": round(p50 * 1e3, 3),
        "tick_p95_ms": round(float(np.percentile(steady, 95)) * 1e3, 3),
        "per_stream_ms": round(p50 * 1e3 / n_streams, 4),
        "gest_s_per_s": round(n_streams * 4.0 / p50, 1),
        "first_tick_ms": round(times[0] * 1e3, 2),
        "streams_bit_equal_to_solo": True,
    }, np.stack(pool_codes)


def main(n_windows: int = 60, device="cuda") -> list:
    out = [soak("wavvq", n_windows, device=device)[0],
           soak("wavlm", n_windows, device=device)[0],
           soak_pool("wavvq", min(n_windows, 20), device=device)[0],
           soak_pool("wavlm", min(n_windows, 20), device=device)[0]]
    print(json.dumps(out))
    return out


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_windows", nargs="?", type=int, default=60)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    main(args.n_windows, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
