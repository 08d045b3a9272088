"""Production serving patterns on synthetic data at real tensor shapes.

The four serving modes of the matching engine (wavvq preset, K1):
  1. single clip  — engine.predict;
  2. bucketed     — engine.predict_bucketed (clip lengths padded up to a
                    bucket of windows; each clip's codes must equal a solo
                    predict of it);
  3. batched      — engine.predict_batch (independent clips as the lanes
                    of one fusion scan, seed chains reset per clip);
  4. multi-stream — serve.StreamingPool (C live sessions advanced one
                    window per tick, per-stream seeds kept on the device).

    python -m qpgesture_tpu_torch.examples.serve_production
        [--device cuda|cpu]

The data are the JAX example's (``RandomState(0)``, J=256, in its draw
order).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .. import bench
from ..core import constants as C
from ..core.config import MATCH_PRESETS
from ..match.database import (stage_database, stage_test_audio,
                              stage_test_context)
from ..match.engine import CodeKNNEngine
from ..serve import StreamingPool


def main(device="cuda", log=print) -> dict:
    """Returns {"single": codes (6, 30), "bucketed": [codes (3, 30), (4,
    30)], "batched": [4 x codes (2, 30)], "pool": codes (3, 8, 30),
    "seconds": {mode: host seconds}}; raises if a bucketed clip's codes
    differ from its solo predict."""
    rng = np.random.RandomState(0)
    J = 256  # database windows (~1024 for speaker-10 scale)
    cfg = MATCH_PRESETS["wavvq"]

    log("== staging database")
    bundle, codes, signature = bench._build_common(rng, J)
    wavvq = rng.randint(0, C.WAVVQ_VOCAB,
                        size=(J, C.WAVVQ_FRAMES, 2)).astype(np.int32)
    db = stage_database(cfg, bundle, codes, signature, wavvq=wavvq)
    engine = CodeKNNEngine(cfg, db, device=device)
    out = {"seconds": {}}

    def make_clip(n_windows):
        tw = rng.randint(0, C.WAVVQ_VOCAB,
                         size=(n_windows, C.WAVVQ_FRAMES, 2)).astype(np.int32)
        tc = rng.randn(n_windows, 30, C.CONTEXT_DIM).astype(np.float32)
        return (stage_test_audio(cfg, db, wavvq=tw),
                stage_test_context(db, tc))

    log("== 1. single clip (6 windows = 24 s)")
    ta, tc = make_clip(6)
    t0 = time.perf_counter()
    res = engine.predict(ta, tc)
    out["seconds"]["single"] = time.perf_counter() - t0
    out["single"] = res.codes
    log(f"   codes {res.codes.shape} in {out['seconds']['single']:.3f}s "
        f"(first call: builds the kernels)")

    log("== 2. bucketed: 3- and 4-window clips padded to one bucket")
    out["bucketed"] = []
    for w in (3, 4):
        ta, tc = make_clip(w)
        t0 = time.perf_counter()
        res = engine.predict_bucketed(ta, tc)
        dt = time.perf_counter() - t0
        solo = engine.predict(ta, tc).codes
        if res.codes.shape != (w, 30) or not np.array_equal(res.codes, solo):
            raise AssertionError(f"bucketed {w}-window clip: codes "
                                 f"{res.codes.shape} differ from solo "
                                 f"predict's")
        out["bucketed"].append(res.codes)
        out["seconds"][f"bucketed_{w}"] = dt
        log(f"   {w} windows -> {res.codes.shape} in {dt:.3f}s, "
            f"== solo predict")

    log("== 3. batched: 4 clips x 2 windows in one scan")
    clips = [make_clip(2) for _ in range(4)]
    clip_audio = np.stack([a for a, _ in clips])
    clip_ctx = np.stack([c for _, c in clips])
    t0 = time.perf_counter()
    results = engine.predict_batch(clip_audio, clip_ctx)
    dt = time.perf_counter() - t0
    out["batched"] = [r.codes for r in results]
    out["seconds"]["batched"] = dt
    log(f"   {len(results)} clips in {dt:.3f}s "
        f"({sum(r.codes.shape[0] * 4 for r in results) / dt:.0f} "
        f"gest-s/s)")

    log("== 4. multi-stream: 8 live sessions, one scan per tick")
    pool = StreamingPool(engine, n_streams=8)
    ticks = []
    for tick in range(3):
        ta = np.stack([make_clip(1)[0][0] for _ in range(8)])
        tc = np.stack([make_clip(1)[1][0] for _ in range(8)])
        t0 = time.perf_counter()
        ticks.append(pool.tick(ta, tc))
        dt = time.perf_counter() - t0
        out["seconds"][f"tick_{tick}"] = dt
        log(f"   tick {tick}: {ticks[-1].shape} codes for 8 streams in "
            f"{dt:.3f}s")
    out["pool"] = np.stack(ticks)
    return out


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    main(p.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
