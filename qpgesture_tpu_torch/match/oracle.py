"""NumPy reference oracle for the matching engine (a copy of the JAX
package's match/oracle.py; numpy only).

A faithful, from-scratch re-implementation of the CodeKNN search semantics
(GestureKNN.py:422-813), used as the spec the device engine is verified
against, and as the host half of the engine's reference-ties mode
(CodeKNNEngine.predict_reference_ties). Structure: the per-step candidate
searches (search_audio_cands :666-691, search_text_cands :708-721) are pure
functions of the query, so they are computed up front; the sequential part
— pose/freq rank fusion, phase re-ranking, and seed chaining — runs as a
Python loop.

Documented deviations from the reference (all affect only exact ties or
error paths; see ops/ranking.py):
  * stable argsort ranks (reference: unstable quicksort tie order);
  * codes never matched in the database (distance stays at 1e3) carry a
    continuation block of the code repeated step_sz times (the reference
    holds an empty list and would emit a short window if such a code ever
    won);
  * float32 throughout (reference mixes float64 NumPy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..core import constants as C
from ..ops.levenshtein import levenshtein_np
from ..ops.ranking import rank_np
from .database import MatchDatabase


def cosine_distance(a: np.ndarray, b: np.ndarray) -> np.float32:
    """1 - cosine similarity, matching sklearn paired_distances('cosine')
    (GestureKNN.py:131,679-685). Zero vectors behave as unit contributions of
    zero similarity (distance 1)."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    na = np.linalg.norm(a)
    nb = np.linalg.norm(b)
    a = a / (na if na > 0 else 1.0)
    b = b / (nb if nb > 0 else 1.0)
    return np.float32(1.0 - np.dot(a, b))


@dataclass
class CandidateTable:
    """Per-step, per-code best candidate (one row of the 512-slot tables the
    reference fills in search_audio_cands/search_text_cands)."""
    dist: np.ndarray    # (512,) f32
    block: np.ndarray   # (512, step_sz) int32 continuation codes
    seq: np.ndarray     # (512,) int32 source sequence j
    frame: np.ndarray   # (512,) int32 source frame int(k)


def _best_per_code(dists: np.ndarray, codes: np.ndarray,
                   blocks: np.ndarray, frames: np.ndarray,
                   codebook_size: int, step_sz: int,
                   unmatched: float) -> CandidateTable:
    """Scan-order (j outer, block inner) strict-< argmin per code
    (GestureKNN.py:686-689). dists: (J, B); codes: (J, B);
    blocks: (J, B, step); frames: (B,)."""
    J, B = dists.shape
    flat_d = dists.reshape(-1)
    flat_c = codes.reshape(-1)
    best_d = np.full(codebook_size, unmatched, dtype=np.float32)
    best_i = np.full(codebook_size, -1, dtype=np.int64)
    for i in range(flat_d.shape[0]):
        c = flat_c[i]
        if flat_d[i] < best_d[c]:
            best_d[c] = flat_d[i]
            best_i[c] = i
    block = np.zeros((codebook_size, step_sz), dtype=np.int32)
    seq = np.zeros(codebook_size, dtype=np.int32)
    frame = np.zeros(codebook_size, dtype=np.int32)
    flat_blocks = blocks.reshape(-1, step_sz)
    for c in range(codebook_size):
        if best_i[c] >= 0:
            block[c] = flat_blocks[best_i[c]]
            seq[c] = best_i[c] // B
            frame[c] = frames[best_i[c] % B]
        else:
            block[c] = c  # deviation: repeat code for never-matched slots
    return CandidateTable(dist=best_d, block=block, seq=seq, frame=frame)


def audio_candidates(db: MatchDatabase, query) -> CandidateTable:
    """search_audio_cands semantics for one step's query."""
    cfg = db.cfg
    J, B = db.aud_codes.shape
    dists = np.zeros((J, B), dtype=np.float32)
    if cfg.audio_mode == "wavvq_feat":
        grouped = db.aud_strings.ndim == 4  # 'sum' mode: (J, B, G, L)
        for j in range(J):
            for b in range(B):
                if grouped:
                    dists[j, b] = sum(
                        levenshtein_np(query[g], db.aud_strings[j, b, g])
                        for g in range(db.aud_strings.shape[2]))
                else:
                    dists[j, b] = levenshtein_np(query,
                                                 db.aud_strings[j, b])
    else:
        for j in range(J):
            for b in range(B):
                dists[j, b] = cosine_distance(query, db.aud_feat[j, b])
    return _best_per_code(dists, db.aud_codes, db.aud_blocks, db.aud_frames,
                          cfg.codebook_size, cfg.step_sz, cfg.unmatched_dist)


def text_candidates(db: MatchDatabase, query: np.ndarray) -> CandidateTable:
    """search_text_cands semantics for one step's context query."""
    cfg = db.cfg
    J, S = db.txt_codes.shape
    dists = np.zeros((J, S), dtype=np.float32)
    for j in range(J):
        for s in range(S):
            dists[j, s] = cosine_distance(query, db.txt_feat[j, s])
    return _best_per_code(dists, db.txt_codes, db.txt_blocks, db.txt_frames,
                          cfg.codebook_size, cfg.step_sz, cfg.unmatched_dist)


def phase_window(db: MatchDatabase, seq: int, frame: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Phase/amp candidate windows for a (sequence, frame) source.

    start = int(frame / 398 * 240) (divisor hard-coded 398 for every mode,
    GestureKNN.py:598). Returns (head (8,16), tail (8,16)): head is
    [phase[:8], amp[:8]] used for the continuity distance; tail is
    [phase[-8:], amp[-8:]] of the 32-frame window, stored as the new seed."""
    start = int(frame / C.WAVVQ_FRAMES * C.NUM_FRAMES)
    ph = db.phase[seq, start:start + 32]   # (32, 8)
    am = db.amp[seq, start:start + 32]
    head = np.concatenate((ph[:8], am[:8]), axis=1)
    tail = np.concatenate((ph[-8:], am[-8:]), axis=1)
    return head.astype(np.float32), tail.astype(np.float32)


def phase_continuity(prev: np.ndarray, head: np.ndarray) -> np.float32:
    """Overlapped phase-window cosine distance (GestureKNN.py:602):
    cos_dist(concat(prev[-5:], head[:3]), concat(prev[-3:], head[:5]))."""
    a = np.concatenate((prev[-5:], head[:3]), axis=0).reshape(-1)
    b = np.concatenate((prev[-3:], head[:5]), axis=0).reshape(-1)
    return cosine_distance(a, b)


@dataclass
class OracleResult:
    codes: np.ndarray                  # (W, 30) int32
    phases: Optional[np.ndarray]       # (W, 8, 16) final per-window phase
    votes: Optional[np.ndarray]        # (W, S) 0=aud, 1=txt (phase+aud+txt)


class CodeKNNOracle:
    """Sequential window-by-window search with seed chaining
    (predict_code_from_audio, GestureKNN.py:724-813).

    tie_kind: 'stable' (default, index-ordered ties — what the device
    engine implements) or 'reference' (NumPy's default unstable introsort,
    bit-matching the reference binary — integer Levenshtein distances tie
    heavily, making the difference observable in wavvq mode).
    """

    def __init__(self, db: MatchDatabase, tie_kind: str = "stable"):
        self.db = db
        self.cfg = db.cfg
        self.tie_kind = tie_kind

    def _rank(self, x: np.ndarray) -> np.ndarray:
        if self.tie_kind == "reference":
            return np.asarray(x).argsort().argsort()
        return rank_np(x)

    def _argsort(self, x: np.ndarray) -> np.ndarray:
        kind = None if self.tie_kind == "reference" else "stable"
        return np.argsort(x, kind=kind)

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

    def search_window(self, aud_tables: List[CandidateTable],
                      txt_tables: Optional[List[CandidateTable]],
                      seed_code: int, seed_phase: Optional[np.ndarray],
                      rand_bits: Optional[np.ndarray] = None):
        """One 4 s window: fuse per-step candidate tables sequentially
        (search_code_knn, GestureKNN.py:501-664)."""
        db, cfg = self.db, self.cfg
        n_steps = len(aud_tables) if aud_tables else len(txt_tables)
        result: List[int] = [seed_code]
        result_phase = [seed_phase] if cfg.use_phase else []
        votes: List[int] = []
        freq_rank = db.freq_rank if db.freq_rank is not None \
            else rank_np(db.freq_dist).astype(np.float32)

        # Scores are rank sums plus freq_weight * freq_rank — every term is
        # a multiple of freq_weight, so score differences that are zero in
        # exact arithmetic can flip sign under float summation order (the
        # reference's f64 sums have the same instability). When freq_weight
        # is 1/K for integer K, compute K-scaled INTEGER scores instead:
        # exact, order-independent, and identical between oracle and engine.
        # freq_weight=0 contributes nothing — same as use_freq=False (and
        # the integer path must not fall back to adding freq at weight 1).
        use_freq = cfg.use_freq and cfg.freq_weight != 0.0
        inv_w = 1.0 / cfg.freq_weight if use_freq else 1.0
        int_scale = int(round(inv_w)) if abs(inv_w - round(inv_w)) < 1e-9 \
            else None
        if self.tie_kind == "reference":
            # the reference sums ranks in float64 (GestureKNN.py:545,579);
            # keep its exact arithmetic for bit-matching runs
            int_scale = None

        for s in range(n_steps):
            prev = result[-1]
            if int_scale is not None:
                pos_score = (self._rank(db.sig_dist[prev]).astype(np.int64)
                             * int_scale)
                if use_freq:
                    pos_score = pos_score + freq_rank.astype(np.int64)
                rank_scale = int_scale
            else:
                pos_score = self._rank(db.sig_dist[prev]).astype(np.float64)
                if use_freq:
                    pos_score = pos_score + freq_rank * cfg.freq_weight
                rank_scale = 1

            aud = aud_tables[s] if cfg.use_aud else None
            txt = txt_tables[s] if cfg.use_txt else None
            if txt is not None:
                txt_score = self._rank(txt.dist) * rank_scale
                combined_txt = pos_score + txt_score
            if aud is not None:
                aud_score = self._rank(aud.dist) * rank_scale
                combined_aud = pos_score + aud_score

            if not cfg.use_phase and cfg.use_txt and cfg.use_aud:
                combined = pos_score + aud_score + txt_score
                c = int(self._argsort(combined)[cfg.desired_k])
                table = aud if rand_bits[s] else txt
                result.extend(int(x) for x in table.block[c])
            elif not cfg.use_phase and cfg.use_aud:
                c = int(self._argsort(combined_aud)[cfg.desired_k])
                result.extend(int(x) for x in aud.block[c])
            elif not cfg.use_phase and cfg.use_txt:
                # reference bug fixed: txt-only emits txt blocks (:591 uses
                # aud_index_cands, which is unbound when use_aud=False)
                c = int(self._argsort(combined_txt)[cfg.desired_k])
                result.extend(int(x) for x in txt.block[c])
            elif cfg.use_phase and cfg.use_aud and not cfg.use_txt:
                order = self._argsort(combined_aud)[:2]
                dists, tails = [], []
                for c in order:
                    head, tail = phase_window(db, aud.seq[c], aud.frame[c])
                    dists.append(phase_continuity(result_phase[-1], head))
                    tails.append(tail)
                fi = int(np.argmin(dists))
                result.extend(int(x) for x in aud.block[order[fi]])
                result_phase.append(tails[fi])
            elif cfg.use_phase and not cfg.use_aud and cfg.use_txt:
                order = self._argsort(combined_txt)[:2]
                dists, tails = [], []
                for c in order:
                    head, tail = phase_window(db, txt.seq[c], txt.frame[c])
                    dists.append(phase_continuity(result_phase[-1], head))
                    tails.append(tail)
                fi = int(np.argmin(dists))
                result.extend(int(x) for x in txt.block[order[fi]])
                result_phase.append(tails[fi])
            elif cfg.use_phase and cfg.use_aud and cfg.use_txt:
                # shipped path: top-1 audio vs top-1 text, phase breaks the
                # tie (GestureKNN.py:627-657)
                ca = int(self._argsort(combined_aud)[0])
                ct = int(self._argsort(combined_txt)[0])
                head_a, tail_a = phase_window(db, aud.seq[ca], aud.frame[ca])
                head_t, tail_t = phase_window(db, txt.seq[ct], txt.frame[ct])
                d_a = phase_continuity(result_phase[-1], head_a)
                d_t = phase_continuity(result_phase[-1], head_t)
                if d_a <= d_t:  # list.index(min) -> first minimum wins
                    result.extend(int(x) for x in aud.block[ca])
                    result_phase.append(tail_a)
                    votes.append(0)
                else:
                    result.extend(int(x) for x in txt.block[ct])
                    result_phase.append(tail_t)
                    votes.append(1)
            else:
                raise ValueError("unsupported flag combination")

        n_keep = cfg.num_frames_code
        codes = np.array(result[1:1 + n_keep], dtype=np.int32)
        phases = result_phase[1:] if cfg.use_phase else None
        return codes, phases, np.array(votes, dtype=np.int32)

    def predict(self, test_audio: np.ndarray,
                test_context: Optional[np.ndarray] = None,
                init_code: Optional[int] = None,
                init_phase: Optional[np.ndarray] = None,
                rng: Optional[np.random.RandomState] = None) -> OracleResult:
        """Match all test windows with seed chaining: window i>0 seeds with
        code result[i-1][-1] and the previous window's final phase
        (GestureKNN.py:789-802)."""
        cfg, db = self.cfg, self.db
        W = test_audio.shape[0] if test_audio is not None \
            else test_context.shape[0]
        aud_tables = None
        if cfg.use_aud:
            aud_tables = [[audio_candidates(db, test_audio[w, s])
                           for s in range(test_audio.shape[1])]
                          for w in range(W)]
        txt_tables = None
        if cfg.use_txt:
            txt_tables = [[text_candidates(db, test_context[w, s])
                           for s in range(test_context.shape[1])]
                          for w in range(W)]
        return self.predict_with_tables(aud_tables, txt_tables, init_code,
                                        init_phase, rng)

    def predict_with_tables(self, aud_tables, txt_tables,
                            init_code: Optional[int] = None,
                            init_phase: Optional[np.ndarray] = None,
                            rng: Optional[np.random.RandomState] = None
                            ) -> OracleResult:
        """The sequential half of predict() over PREcomputed candidate
        tables ([W][S] lists of CandidateTable). Table construction draws no
        randomness, so running it up front preserves the reference's rng
        order (init draw, then per-window re-seeds / rand bits). This entry
        point is also how the device engine's reference-ties mode works:
        phase-1 tables come off the chip, phase-2 fuses here in the
        reference's own float64 arithmetic."""
        cfg = self.cfg
        rng = rng or np.random.RandomState(cfg.seed)
        W = len(aud_tables) if aud_tables is not None else len(txt_tables)
        if init_code is None:
            init_code, got_phase = self.init_code_phase(rng)
            if init_phase is None:
                init_phase = got_phase

        all_codes, all_phases, all_votes = [], [], []
        seed_code, seed_phase = init_code, init_phase
        for w in range(W):
            if w > 0 and not cfg.chain_windows:
                # mfcc/raw dispatches pass no seeds: every window draws a
                # fresh init (GestureKNN.py:797,804,806 -> :510-522)
                seed_code, seed_phase = self.init_code_phase(rng)
            aud_w = aud_tables[w] if cfg.use_aud else None
            txt_w = txt_tables[w] if cfg.use_txt else None
            n_steps = len(aud_w) if aud_w else len(txt_w)
            rand_bits = (rng.rand(n_steps) > 0.5).astype(np.int32) \
                if (not cfg.use_phase and cfg.use_aud and cfg.use_txt) \
                else None
            codes, phases, votes = self.search_window(
                aud_w, txt_w, seed_code, seed_phase, rand_bits)
            all_codes.append(codes)
            if phases:
                all_phases.append(phases[-1])
            all_votes.append(votes)
            seed_code = int(codes[-1])
            seed_phase = phases[-1] if phases else None
        return OracleResult(
            codes=np.stack(all_codes),
            phases=np.stack(all_phases) if all_phases else None,
            votes=np.stack(all_votes) if all_votes[0].size else None)
