"""How often the engine's stable ties diverge from the reference's
introsort ties on the wavvq path.

The reference ranks candidates with NumPy's default unstable introsort
(argsort().argsort(), GestureKNN.py:540,553); the engine breaks ties by
index. Integer edit distances tie heavily, so the two can select different
codebook indices; ``predict_reference_ties`` gives the reference's order.
This sweep runs N random fixtures through both fusions over the same
device-computed candidate tables (K1 on the card) and reports the fraction
of clips with any differing index, the fraction of indices differing, and
the largest per-clip fraction.

    python -m qpgesture_tpu_torch.examples.tie_divergence_sweep
        [n_fixtures] [--device cuda|cpu]

NumPy's unstable sort may order ties differently on another CPU: compare
fractions taken on one host.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core.config import MATCH_PRESETS, MatchConfig
from ..match.database import (stage_database, stage_test_audio,
                              stage_test_context)
from ..match.engine import CodeKNNEngine
from .fixtures import make_fixture


def main(n_fixtures: int = 40, device="cuda", log=print) -> dict:
    clip_div = []
    idx_div = []
    for i in range(n_fixtures):
        rng = np.random.RandomState(10_000 + i)
        fx = make_fixture(rng, n_seq=6, n_test=3, codebook=128)
        cfg = MatchConfig(**{**MATCH_PRESETS["wavvq"].__dict__,
                             "codebook_size": 128})
        db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                            wavvq=fx["wavvq"])
        ta = stage_test_audio(cfg, db, wavvq=fx["test_wavvq"])
        tc = stage_test_context(db, fx["test_context"])
        engine = CodeKNNEngine(cfg, db, device=device)
        stable = engine.predict(ta, tc,
                                rng=np.random.RandomState(cfg.seed)).codes
        ref = engine.predict_reference_ties(
            ta, tc, rng=np.random.RandomState(cfg.seed)).codes
        diff = (stable != ref)
        clip_div.append(bool(diff.any()))
        idx_div.append(float(diff.mean()))
    out = {
        "n_fixtures": n_fixtures,
        "clips_with_any_divergence": float(np.mean(clip_div)),
        "mean_index_divergence": float(np.mean(idx_div)),
        "max_index_divergence": float(np.max(idx_div)),
    }
    log(out)
    return out


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_fixtures", nargs="?", type=int, default=40)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    main(args.n_fixtures, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
