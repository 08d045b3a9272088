"""Randomized engine / oracle parity soak.

Sweeps every mode preset over many random fixtures and holds the device
engine's selected codebook indices to the NumPy oracle's, bit for bit: the
long-form insurance behind the one-fixture-per-preset tests. Run it after
any change to the scoring path.

    python -m qpgesture_tpu_torch.examples.parity_soak [n_per_preset]
        [--device cuda|cpu]

Exits 1 on any mismatch.
"""
from __future__ import annotations

import argparse
import sys
import zlib

import numpy as np

from ..core.config import MATCH_PRESETS, MatchConfig
from ..match.database import (stage_database, stage_test_audio,
                              stage_test_context)
from ..match.engine import CodeKNNEngine
from ..match.oracle import CodeKNNOracle
from .fixtures import make_fixture

PRESETS = ["wavvq", "shipped", "no_phase", "no_text", "no_audio", "mfcc",
           "wavvq_aud_only", "wavlm_raw", "mfcc_raw"]


def match_fixture(preset: str, seed: int, device="cuda", **overrides):
    """One fixture of ``RandomState(seed)`` (4 database windows, a 2-window
    clip, 64 codes) matched at ``preset`` (with ``overrides`` of its
    MatchConfig) by the engine on ``device`` and by the oracle on the
    host. Returns (engine codes, oracle codes)."""
    rng = np.random.RandomState(seed)
    fx = make_fixture(rng, n_seq=4, n_test=2, codebook=64)
    cfg = MatchConfig(**{**MATCH_PRESETS[preset].__dict__,
                         "codebook_size": 64, **overrides})
    db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                        wavlm=fx["wavlm"], wavvq=fx["wavvq"])
    ta = stage_test_audio(cfg, db, test_bundle=fx["test_bundle"],
                          wavlm=fx["test_wavlm"],
                          wavvq=fx["test_wavvq"]) if cfg.use_aud else None
    tc = stage_test_context(db, fx["test_context"]) if cfg.use_txt \
        else None
    oracle = CodeKNNOracle(db).predict(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    engine = CodeKNNEngine(cfg, db, device=device).predict(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    return engine.codes, oracle.codes


def soak_seed(preset: str, i: int) -> int:
    return 90000 + zlib.crc32(preset.encode()) % 5000 + 131 * i


def run(n_per_preset: int = 25, device="cuda", log=print):
    """Every preset over n_per_preset fixtures. Returns (mismatches, rows):
    one row a fixture, {"preset", "seed", "n_diff"}."""
    bad = 0
    rows = []
    for preset in PRESETS:
        for i in range(n_per_preset):
            seed = soak_seed(preset, i)
            got, want = match_fixture(preset, seed, device)
            n_diff = int((got != want).sum())
            rows.append({"preset": preset, "seed": seed, "n_diff": n_diff})
            if n_diff:
                bad += 1
                log(f"MISMATCH {preset} seed={seed}")
        log(f"{preset} done")
    log(f"soak complete: {len(rows)} runs, {bad} mismatches")
    return bad, rows


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_per_preset", nargs="?", type=int, default=25)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(f"device: {args.device}", flush=True)
    bad, _ = run(args.n_per_preset, args.device,
                 log=lambda s: print(s, flush=True))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(cli())
