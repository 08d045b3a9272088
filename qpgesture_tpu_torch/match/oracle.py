"""The parts of the NumPy matching oracle that sit on the predict path.

The reference package's match/oracle.py is a full NumPy spec of the CodeKNN
search (GestureKNN.py:422-813). The engine's predict path needs only the
result record and the random initial seed draw; the rest of the spec (the
per-step candidate searches and the sequential fusion) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .database import MatchDatabase


@dataclass
class OracleResult:
    codes: np.ndarray                  # (W, 30) int32
    phases: Optional[np.ndarray]       # (W, 8, 16) final per-window phase
    votes: Optional[np.ndarray]        # (W, S) 0=aud, 1=txt (phase+aud+txt)


class CodeKNNOracle:
    """Sequential window-by-window search with seed chaining
    (predict_code_from_audio, GestureKNN.py:724-813) — here only its
    initial-seed draw."""

    def __init__(self, db: MatchDatabase):
        self.db = db
        self.cfg = db.cfg

    def init_code_phase(self, rng: np.random.RandomState):
        """Random initial seed (init_code_phase, GestureKNN.py:462-473).
        Deviation: init_j is clamped so the 8-frame phase window stays inside
        the stored 240-frame phase arrays."""
        db, cfg = self.db, self.cfg
        init_i = rng.randint(0, db.n_seq)
        hi = db.geom.n_db_frm - int(cfg.num_frames / cfg.num_frames_code)
        init_j = rng.randint(0, hi)
        init_code = int(db.code_train[init_i, init_j // cfg.num_frames_code])
        if not cfg.use_phase:
            return init_code, None
        w = int(cfg.num_frames / cfg.num_frames_code)  # 8
        j = min(init_j, db.phase.shape[1] - w)
        ph = db.phase[init_i, j:j + w]
        am = db.amp[init_i, j:j + w]
        return init_code, np.concatenate((ph, am), axis=1).astype(np.float32)
