"""Engine / oracle parity sweep on the card.

The CPU tests hold the port to the JAX package; this sweep holds the
card's engine to the NumPy oracle over every preset, bit for bit, where
the card's own arithmetic (cuBLAS, K1) scores the candidates. It also runs
the raw-pose GestureKNN engine against its NumPy search and the
reference's 3600-frame long-clip mfcc variant.

    python -m qpgesture_tpu_torch.examples.chip_parity_sweep
        [n_fixtures_per_preset] [--cosine-precision=highest|high|default]
        [--feat-dtype=float32|bfloat16|float16] [--device cuda|cpu]

--cosine-precision sets MatchConfig.cosine_precision of every preset
(the audio cosine's GEMM precision); --feat-dtype stages the audio
database at that residency (MatchConfig.feat_dtype). Below "highest" /
float32 the counts of differing codes measure the divergence from the
float32 oracle. Exits 1 on any mismatch.
"""
from __future__ import annotations

import argparse
import sys
import zlib

import numpy as np

from ..core.config import MATCH_PRESETS, MatchConfig
from ..match.database import stage_database, stage_test_audio
from ..match.engine import CodeKNNEngine
from ..match.gesture_knn import (GestureKNNData, GestureKNNEngine,
                                 search_motion_np)
from ..match.oracle import CodeKNNOracle
from .fixtures import make_long_fixture
from .parity_soak import PRESETS, match_fixture

GESTURE_ATOL = 1e-5


def run_gesture_knn(n_fixtures: int = 3, device="cuda", log=print):
    """Raw-pose GestureKNN engine on ``device`` against the NumPy search
    (atol GESTURE_ATOL). Returns (mismatches, rows {"fixture",
    "max_abs_err"})."""
    mismatches = 0
    rows = []
    for i in range(n_fixtures):
        rng = np.random.RandomState(31 + i)
        K, L, A, P, J = 5, 64, 12, 8, 15
        db = GestureKNNData(
            feat=rng.randn(K, L, A + P).astype(np.float32),
            motion=rng.randn(K, L, J).astype(np.float32),
            control_mask=np.ones((K, L)), n_aud=A)
        feat_test = rng.randn(A, 64).astype(np.float32)
        got = GestureKNNEngine(db, device=device).search_motion(
            feat_test, init_seq=1, init_frm=10)
        want = search_motion_np(db, feat_test, init_seq=1, init_frm=10)
        same = np.allclose(got, want, atol=GESTURE_ATOL)
        rows.append({"fixture": i,
                     "max_abs_err": float(np.abs(got - want).max())})
        log(f"gesture_knn      fixture {i}: {'OK' if same else 'MISMATCH'}")
        mismatches += 0 if same else 1
    return mismatches, rows


def long_clip_codes(device="cuda"):
    """The reference's 3600-frame (60 s) mfcc variant in one window (113
    steps x 4 codes, 450 kept) on ``RandomState(3600)``'s fixture.
    Returns (engine codes on ``device``, oracle codes), each (2, 450)."""
    fx = make_long_fixture(np.random.RandomState(3600))
    cfg = MatchConfig(**{**MATCH_PRESETS["mfcc"].__dict__,
                         "codebook_size": 48,
                         "num_frames": 3600, "num_frames_code": 450})
    db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"])
    ta = stage_test_audio(cfg, db, test_bundle=fx["test_bundle"])
    want = CodeKNNOracle(db).predict(
        ta, None, rng=np.random.RandomState(cfg.seed)).codes
    got = CodeKNNEngine(cfg, db, device=device).predict(
        ta, None, rng=np.random.RandomState(cfg.seed)).codes
    return got, want


def run_long_clip(device="cuda", log=print):
    """long_clip_codes held engine against oracle. Returns (mismatches,
    rows [{"name", "n_diff", "codes"}]), the engine's codes in the row."""
    got, want = long_clip_codes(device)
    n_diff = int((got != want).sum()) if got.shape == want.shape \
        else want.size
    log(f"long_clip_3600   : {'OK' if n_diff == 0 else 'MISMATCH'}")
    return int(n_diff > 0), [{"name": "long_clip_3600", "n_diff": n_diff,
                              "codes": got}]


def sweep_seed(preset: str, i: int) -> int:
    return 2024 + zlib.crc32(preset.encode()) % 1000 + 7919 * i


def run(n_fixtures: int = 3, cosine_precision: str = "highest",
        feat_dtype: str = "float32", device="cuda", log=print):
    """Every preset over n_fixtures fixtures, then the gesture KNN and the
    long clip. Returns (mismatched runs, rows): a row a fixture {"preset",
    "fixture", "seed", "n_diff"}, then those of the gesture KNN and the
    long clip."""
    log(f"device: {device}, cosine_precision={cosine_precision}, "
        f"feat_dtype={feat_dtype}")
    mismatches = 0
    rows = []
    for preset in PRESETS:
        for i in range(n_fixtures):
            seed = sweep_seed(preset, i)
            got, want = match_fixture(preset, seed, device,
                                      cosine_precision=cosine_precision,
                                      feat_dtype=feat_dtype)
            n_diff = int((got != want).sum())
            rows.append({"preset": preset, "fixture": i, "seed": seed,
                         "n_diff": n_diff})
            log(f"{preset:16s} fixture {i}: "
                f"{'OK' if not n_diff else f'MISMATCH ({n_diff} codes)'}")
            mismatches += 1 if n_diff else 0
    for part in (run_gesture_knn(n_fixtures, device, log),
                 run_long_clip(device, log)):
        mismatches += part[0]
        rows += part[1]
    log("PARITY CLEAN" if mismatches == 0 else
        f"{mismatches} runs mismatched")
    return mismatches, rows


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_fixtures", nargs="?", type=int, default=3)
    p.add_argument("--cosine-precision", default="highest",
                   choices=["highest", "high", "default"])
    p.add_argument("--feat-dtype", default="float32",
                   choices=["float32", "bfloat16", "float16"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bad, _ = run(args.n_fixtures, args.cosine_precision, args.feat_dtype,
                 args.device, log=lambda s: print(s, flush=True))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(cli())
