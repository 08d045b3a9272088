"""Motion matching engine (PyTorch).

The reference's CodeKNN re-executes a full database scan in Python for every
4-code step of every window (search_audio_cands, GestureKNN.py:666-691).
Like the JAX engine this port keeps the database resident on the device and
matches a whole clip in two phases:

  phase 1 (parallel): distances from *all* (window, step) queries to *all*
    (sequence, block) database positions — one float32 matmul for cosine
    modes, the CUDA edit-distance kernel (ops/levenshtein_cuda.py) for the
    wavvq mode — followed by a per-code segment-min (the 512-slot candidate
    tables).
  phase 2 (sequential): the fusion scan over steps carrying (prev_code,
    prev_phase). Candidate selection for every (step, prev_code) is
    tabulated before the loop; each step then gathers its selection, runs
    the phase re-rank and chains the seed. The loop runs on the host and
    its carry stays on the device: no step reads a device value back. C
    clips (or streams) run as C lanes of the same loop, each step
    advancing every lane with batched gathers; one clip is one lane.

Semantics are bit-matched to the JAX engine (qpgesture_tpu/match/engine.py):
stable ranks, lowest-index tie order in every selection, integer-scaled
scores, and the same random draw order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import MatchConfig
from ..device import DeviceLike, resolve_device, to_device
from ..ops.levenshtein_cuda import levenshtein_matrix
from ..ops.ranking import rank, rank_np
from .database import MatchDatabase
from .geometry import phase_start
from .oracle import CodeKNNOracle, OracleResult

# Rows of the (rows, 512, 512) int32 selection-score tensor materialised at
# once by _tabulate_selection: 128 rows is 128 MB.
SEL_CHUNK_ROWS = 128


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Row-normalize, leaving zero rows at zero (sklearn normalize semantics,
    so cosine distance to a zero vector is 1)."""
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.where(n > 0, n, torch.ones_like(n))


def cosine_distance_prenorm(q: torch.Tensor,
                            dn: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) cosine distances, the database side already
    row-normalized. A true float32 matmul (TF32 is off package-wide)."""
    return 1.0 - _l2_normalize(q) @ dn.T


def segment_min_argmin(dist: torch.Tensor, seg: torch.Tensor, k: int,
                       unmatched: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-code candidate reduction.

    dist: (Q, N) distances; seg: (N,) int64 code of each database position.
    Returns (Q, k) min distance per code (``unmatched`` where a code never
    occurs), (Q, k) the *first* argmin position in scan order — the
    reference's strict-< update order (GestureKNN.py:686-689) — and (Q, k)
    whether the code occurs at all.
    """
    Q, N = dist.shape
    idx = seg.expand(Q, N)
    mins = torch.full((Q, k), float("inf"), dtype=dist.dtype,
                      device=dist.device).scatter_reduce(
        1, idx, dist, "amin", include_self=False)
    hit = dist == mins.gather(1, idx)
    pos = torch.where(hit, torch.arange(N, device=dist.device).expand(Q, N),
                      N)
    args = torch.full((Q, k), N, dtype=torch.int64,
                      device=dist.device).scatter_reduce(
        1, idx, pos, "amin", include_self=False)
    matched = torch.isfinite(mins)
    mins = torch.where(matched, mins, torch.full_like(mins, unmatched))
    args = torch.where(args >= N, 0, args)
    return mins, args, matched


@dataclass
class DeviceTables:
    """Per-(window*step) candidate tables on the device."""
    aud_rank: Optional[torch.Tensor]    # (Q, 512) i32 rank of audio distance
    aud_block: Optional[torch.Tensor]   # (Q, 512, step_sz) i64
    aud_seq: Optional[torch.Tensor]     # (Q, 512) i64
    aud_start: Optional[torch.Tensor]   # (Q, 512) i64 phase window start
    txt_rank: Optional[torch.Tensor]
    txt_block: Optional[torch.Tensor]
    txt_seq: Optional[torch.Tensor]
    txt_start: Optional[torch.Tensor]
    n_steps: int
    # (Q, 512) i64 flat argmin position (seq * B + block): the row index into
    # DeviceDatabase's head/tail grids
    aud_pos: Optional[torch.Tensor] = None
    txt_pos: Optional[torch.Tensor] = None


@dataclass
class DeviceDatabase:
    """Static per-database device state."""
    # (512, 512) i32: sig_rank[c] = stable rank of the signature distances
    # sig_dist[c] (+inf diagonal), the pose score for prev_code c
    sig_rank: torch.Tensor
    freq_rank: torch.Tensor             # (512,) i32 frequency ranks
    # (J*B, 2, 8, 16) f32: every candidate's 32-frame phase (head, tail)
    # block pair on the (sequence, block-start) grid, per side (phase
    # modes only)
    aud_ht: Optional[torch.Tensor] = None
    txt_ht: Optional[torch.Tensor] = None


def tables_from_minargs(cfg: MatchConfig, mins: torch.Tensor,
                        args: torch.Tensor, matched: torch.Tensor,
                        blocks: torch.Tensor, starts: torch.Tensor):
    """Per-code (rank, block, seq, start, pos) tables from reduced per-code
    (min dist, global argmin flat index, matched) arrays. blocks: (J, B, s)
    continuation-code table; starts: (B,) phase-window start per block."""
    J, B = blocks.shape[:2]
    blk = blocks.reshape(J * B, -1)[args]                     # (Q, 512, step)
    code_ids = torch.arange(cfg.codebook_size, device=blk.device)
    blk = torch.where(matched[..., None], blk,
                      code_ids[None, :, None].expand_as(blk))
    return rank(mins), blk, args // B, starts[args % B], args


@dataclass
class DeviceMatchDB:
    """Staged database tensors resident on the device."""
    aud_feat: Optional[torch.Tensor]    # (J*B, D) f32 or (J, B[, G], L) i32
    aud_codes: Optional[torch.Tensor]   # (J, B) i64
    aud_blocks: Optional[torch.Tensor]  # (J, B, step) i64
    aud_starts: Optional[torch.Tensor]  # (B,) i64 phase window starts
    txt_feat: Optional[torch.Tensor]    # (J*S, D) f32, row-normalized
    txt_codes: Optional[torch.Tensor]
    txt_blocks: Optional[torch.Tensor]
    txt_starts: Optional[torch.Tensor]


def _index_tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _head_tail_grid(phase: torch.Tensor, amp: torch.Tensor,
                    starts: torch.Tensor) -> torch.Tensor:
    """All candidates' phase (head, tail) block pairs on the (J, B) grid,
    flattened to (J*B, 2, 8, 16) so a flat argmin position indexes a row
    pair directly. The clamp reproduces a dynamic slice's out-of-bounds
    clamp."""
    T = phase.shape[1]
    s = starts.clamp(0, T - 32)                                # (B,)
    rows = s[:, None] + torch.arange(32, device=s.device)      # (B, 32)
    ph = phase[:, rows]                                        # (J, B, 32, 8)
    am = amp[:, rows]
    head = torch.cat((ph[..., :8, :], am[..., :8, :]), dim=-1)
    tail = torch.cat((ph[..., 24:, :], am[..., 24:, :]), dim=-1)
    JB = head.shape[0] * head.shape[1]
    return torch.stack((head.reshape(JB, 8, 16),
                        tail.reshape(JB, 8, 16)), dim=1)


def device_match_db(cfg: MatchConfig, db: MatchDatabase,
                    device: torch.device) -> DeviceMatchDB:
    if cfg.feat_dtype != "float32":
        raise NotImplementedError(
            f"feat_dtype={cfg.feat_dtype!r} is not ported yet (float32 only)")
    if cfg.cosine_precision != "highest":
        raise NotImplementedError(
            f"cosine_precision={cfg.cosine_precision!r} is not ported yet "
            "(cosine distances run in true float32)")
    starts = lambda frames: _index_tensor(phase_start(frames), device)
    aud = (None,) * 4
    if cfg.use_aud:
        if cfg.audio_mode == "wavvq_feat":
            feat = torch.as_tensor(db.aud_strings, dtype=torch.int32,
                                   device=device)
        else:
            flat = db.aud_feat.reshape(-1, db.aud_feat.shape[-1])
            feat = _l2_normalize(torch.as_tensor(flat, dtype=torch.float32,
                                                 device=device))
        aud = (feat, _index_tensor(db.aud_codes, device),
               _index_tensor(db.aud_blocks, device), starts(db.aud_frames))
    txt = (None,) * 4
    if cfg.use_txt:
        flat = db.txt_feat.reshape(-1, db.txt_feat.shape[-1])
        txt = (_l2_normalize(torch.as_tensor(flat, dtype=torch.float32,
                                             device=device)),
               _index_tensor(db.txt_codes, device),
               _index_tensor(db.txt_blocks, device), starts(db.txt_frames))
    return DeviceMatchDB(*aud, *txt)


def _edit_distances(q: torch.Tensor, flat_db: torch.Tensor) -> torch.Tensor:
    """Levenshtein distance matrix: the CUDA kernel for CUDA tensors, its
    plain PyTorch version for CPU tensors (the wrapper decides)."""
    return levenshtein_matrix(q.contiguous(), flat_db.contiguous())


def string_distance_matrix(q: torch.Tensor,
                           feat: torch.Tensor) -> torch.Tensor:
    """wavvq edit-distance dispatch: q (Q, L) with feat (N, ..., L) for
    'combine' mode, or q (Q, G, L) with feat (..., G, L) for 'sum' mode
    (per-group distances summed, GestureKNN.py:63-66). Returns (Q, N) f32."""
    if q.dim() == 3:  # 'sum' mode
        G = q.shape[1]
        flat_db = feat.reshape(-1, G, feat.shape[-1])
        total = _edit_distances(q[:, 0], flat_db[:, 0])
        for g in range(1, G):
            total = total + _edit_distances(q[:, g], flat_db[:, g])
        return total.to(torch.float32)
    return _edit_distances(
        q, feat.reshape(-1, feat.shape[-1])).to(torch.float32)


def _minargs_one_side(cfg: MatchConfig, q, feat, codes, is_strings: bool):
    """Distance matrix + per-code segment-min for one (audio|text) side.
    Returns (mins (Q, 512), args (Q, 512) flat argmin, matched (Q, 512))."""
    if is_strings:
        dist = string_distance_matrix(q, feat)
    else:
        dist = cosine_distance_prenorm(q, feat)
    return segment_min_argmin(dist, codes.reshape(-1), cfg.codebook_size,
                              cfg.unmatched_dist)


def _raw_tables_impl(cfg: MatchConfig, devdb: DeviceMatchDB, test_audio,
                     test_context):
    """Phase 1 without rank conversion: the raw per-code (min distance,
    argmin position, matched) triples of each side (None when unused)."""
    aud = txt = None
    if cfg.use_aud:
        W, S = test_audio.shape[:2]
        q = test_audio.reshape(W * S, *test_audio.shape[2:])
        aud = _minargs_one_side(cfg, q, devdb.aud_feat, devdb.aud_codes,
                                cfg.audio_mode == "wavvq_feat")
    if cfg.use_txt:
        W, S = test_context.shape[:2]
        q = test_context.reshape(W * S, -1)
        txt = _minargs_one_side(cfg, q, devdb.txt_feat, devdb.txt_codes,
                                False)
    return aud, txt


def _tables_impl(cfg: MatchConfig, devdb: DeviceMatchDB, test_audio,
                 test_context) -> DeviceTables:
    """Phase 1: all queries vs all database positions, reduced per code."""
    aud_raw, txt_raw = _raw_tables_impl(cfg, devdb, test_audio, test_context)
    aud = txt = (None,) * 5
    if aud_raw is not None:
        aud = tables_from_minargs(cfg, *aud_raw, devdb.aud_blocks,
                                  devdb.aud_starts)
    if txt_raw is not None:
        txt = tables_from_minargs(cfg, *txt_raw, devdb.txt_blocks,
                                  devdb.txt_starts)
    lead = test_audio if cfg.use_aud else test_context
    return DeviceTables(aud_rank=aud[0], aud_block=aud[1], aud_seq=aud[2],
                        aud_start=aud[3], txt_rank=txt[0], txt_block=txt[1],
                        txt_seq=txt[2], txt_start=txt[3],
                        n_steps=lead.shape[1], aud_pos=aud[4],
                        txt_pos=txt[4])


def _int_scale(cfg: MatchConfig) -> int:
    """K = 1/freq_weight as the exact-integer score scale: every term of
    pos + freq_weight*freq + rank is a multiple of freq_weight, so
    K*pos + freq + K*rank scores in int32. freq_weight=0 means the frequency
    term contributes nothing (same as use_freq=False)."""
    if cfg.use_freq and cfg.freq_weight != 0.0:
        inv_w = 1.0 / cfg.freq_weight
        assert abs(inv_w - round(inv_w)) < 1e-9, (
            "freq_weight must be 1/K for exact integer scoring")
        return int(round(inv_w))
    return 1


def _stable_order(s: torch.Tensor) -> torch.Tensor:
    """argsort along the last axis with ties in index order (lax.top_k's
    tie order, which the JAX engine relies on)."""
    return torch.sort(s, dim=-1, stable=True).indices


def _tabulate_selection(cfg: MatchConfig, dev: DeviceDatabase,
                        tables: DeviceTables, scale: int):
    """Precompute the scan's candidate selection for every (step,
    prev_code): selection depends only on the step's rank row and the
    carried prev_code, and every score term is an exact integer, so it is
    one batched selection over a (Q, 512 prev-codes, 512 candidates) int32
    score tensor, built SEL_CHUNK_ROWS steps at a time.

    Returns (sel_a, sel_b):
      no-phase modes          -> sel_a (Q, P) the chosen candidate, sel_b None
      phase + one side        -> sel_a (Q, P, 2) the top-2 order, sel_b None
      phase + both sides      -> sel_a (Q, P) audio argmin, sel_b (Q, P) text
    """
    base = dev.sig_rank * scale                               # (P, N) i32
    if cfg.use_freq and cfg.freq_weight != 0.0:
        base = base + dev.freq_rank[None, :]

    def chunked(f, R):
        return torch.cat([f(base[None, :, :] + Rc[:, None, :])
                          for Rc in torch.split(R, SEL_CHUNK_ROWS)])

    r_a = tables.aud_rank * scale if cfg.use_aud else None
    r_t = tables.txt_rank * scale if cfg.use_txt else None
    if not cfg.use_phase:
        r = r_a + r_t if (cfg.use_aud and cfg.use_txt) else \
            (r_a if cfg.use_aud else r_t)
        k = cfg.desired_k
        return chunked(lambda s: _stable_order(s)[..., k], r), None
    if cfg.use_aud and cfg.use_txt:
        amin = lambda s: torch.argmin(s, dim=-1)   # first minimum on ties
        return chunked(amin, r_a), chunked(amin, r_t)
    return chunked(lambda s: _stable_order(s)[..., :2],
                   r_a if cfg.use_aud else r_t), None


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two) as a fixed binary tree of
    elementwise adds: the same IEEE operations in the same order on every
    device, so the CPU and the GPU compute bit-equal values."""
    n = x.shape[-1]
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:]
    return x[..., 0]


def _phase_continuity(prev: torch.Tensor, heads: torch.Tensor
                      ) -> torch.Tensor:
    """prev (C, 8, 16), heads (C, K, 8, 16) -> (C, K) distances
    cos_dist(concat(prev[-5:], head[:3]), concat(prev[-3:], head[:5])), one
    row of K candidates per lane. Elementwise operations and a fixed tree
    sum, so a lane's values do not depend on C."""
    C, K = heads.shape[:2]
    a = torch.cat((prev[:, None, 3:].expand(C, K, 5, 16), heads[:, :, :3]),
                  2).reshape(C, K, -1)
    b = torch.cat((prev[:, None, 5:].expand(C, K, 3, 16), heads[:, :, :5]),
                  2).reshape(C, K, -1)
    n = torch.sqrt(_tree_sum(torch.cat((a * a, b * b), 1)))  # (C, 2K)
    n = torch.where(n > 0, n, torch.ones_like(n))
    return 1.0 - _tree_sum((a / n[:, :K, None]) * (b / n[:, K:, None]))


def _fuse_scan_clips(cfg: MatchConfig, n_steps: int, clips: int,
                     dev: DeviceDatabase, tables: DeviceTables,
                     rand_bits: Optional[np.ndarray],
                     reset_mask: np.ndarray, reset_code, reset_phase):
    """Phase 2 for C independent clips run as lanes of one loop:
    sequential rank fusion + phase re-rank + seed chain.

    The Q = C*L steps of the flat tables are C lanes of L steps each (the
    JAX package vmaps one scan body over them). The loop runs on the host,
    one iteration per step of a lane, and every iteration advances all C
    lanes with batched gathers: the launches of one clip, C clips' work.
    Each lane computes exactly what a solo run of its clip computes.

    Selection is tabulated once on the flat tables. rand_bits (Q,) is a
    host array (no-phase aud+txt mode; a lane picks its side with a
    torch.where). reset_mask (Q,) is a host array, the same in every lane;
    at its steps the lane's carry becomes reset_code / reset_phase ((Q,)
    and (Q, 8, 16), host arrays or device tensors, read on the device only),
    so seeds carried on the device never come back to the host. A lane
    without a reset at step 0 starts from code 0 and a zero phase, as in
    the JAX package. Returns device tensors (blocks (Q, step), phases
    (Q, 8, 16), votes (Q,))."""
    use_phase, use_aud, use_txt = cfg.use_phase, cfg.use_aud, cfg.use_txt
    if not (use_aud or use_txt):
        raise ValueError("unsupported flag combination")
    Q = (tables.aud_rank if use_aud else tables.txt_rank).shape[0]
    C = clips
    if Q % C:
        raise ValueError(f"{Q} steps do not split into {C} lanes")
    L = Q // C
    # Cross-window seed geometry: the kept code result[num_frames_code]
    # (appended index num_frames_code-1) must land in the final step's block.
    seed_i = cfg.num_frames_code - 1
    assert seed_i // cfg.step_sz == n_steps - 1, (
        f"cross-window seed (kept code {cfg.num_frames_code}) falls in step "
        f"{seed_i // cfg.step_sz}, not the final step {n_steps - 1}; this "
        f"clip_len/step_sz/num_frames_code geometry is unsupported "
        f"(need (num_frames_code-1)//step_sz == n_steps-1)")
    seed_off = seed_i % cfg.step_sz
    mask = np.asarray(reset_mask, bool).reshape(C, L)
    if not (mask == mask[:1]).all():
        raise ValueError("the reset steps must be the same in every lane")
    mask = mask[0]
    device = dev.sig_rank.device

    def lanes(x):
        return None if x is None else x.reshape((C, L) + x.shape[1:])

    sel_a, sel_b = map(lanes, _tabulate_selection(cfg, dev, tables,
                                                  _int_scale(cfg)))
    aud_block, txt_block = lanes(tables.aud_block), lanes(tables.txt_block)
    aud_pos, txt_pos = lanes(tables.aud_pos), lanes(tables.txt_pos)
    if mask.any():
        reset_code = lanes(to_device(reset_code, device, torch.int64))
        reset_phase = lanes(to_device(reset_phase, device, torch.float32))
    if rand_bits is not None:
        rand_bits = lanes(to_device(np.asarray(rand_bits) > 0, device))

    ar = torch.arange(C, device=device)
    prev_code = torch.zeros((C,), dtype=torch.int64, device=device)
    prev_phase = torch.zeros((C, 8, 16), dtype=torch.float32, device=device)
    zero_vote = torch.zeros((C,), dtype=torch.int32, device=device)
    blocks, phases, votes = [], [], []
    for t in range(L):
        if mask[t]:
            prev_code = reset_code[:, t]
            prev_phase = reset_phase[:, t]
        out_phase = prev_phase
        vote = zero_vote
        if not use_phase:
            c = sel_a[:, t].gather(1, prev_code[:, None])[:, 0]   # (C,)
            if use_aud and use_txt:
                block = torch.where(rand_bits[:, t, None],
                                    aud_block[:, t][ar, c],
                                    txt_block[:, t][ar, c])
            else:
                side = aud_block if use_aud else txt_block
                block = side[:, t][ar, c]
        elif use_aud != use_txt:
            s_blk, s_pos, s_grid = (
                (aud_block, aud_pos, dev.aud_ht) if use_aud
                else (txt_block, txt_pos, dev.txt_ht))
            order = sel_a[:, t][ar, prev_code]                    # (C, 2)
            pairs = s_grid[s_pos[:, t].gather(1, order)]    # (C, 2, 2, 8, 16)
            d = _phase_continuity(prev_phase, pairs[:, :, 0])     # (C, 2)
            pick0 = d[:, 0] <= d[:, 1]
            c = torch.where(pick0, order[:, 0], order[:, 1])
            block = s_blk[:, t][ar, c]
            out_phase = torch.where(pick0[:, None, None], pairs[:, 0, 1],
                                    pairs[:, 1, 1])
        else:
            ca = sel_a[:, t][ar, prev_code]
            ct = sel_b[:, t][ar, prev_code]
            pa = dev.aud_ht[aud_pos[:, t][ar, ca]]                # (C, 2, 8, 16)
            pt = dev.txt_ht[txt_pos[:, t][ar, ct]]
            d = _phase_continuity(prev_phase,
                                  torch.stack((pa[:, 0], pt[:, 0]), 1))
            pick_aud = d[:, 0] <= d[:, 1]
            block = torch.where(pick_aud[:, None], aud_block[:, t][ar, ca],
                                txt_block[:, t][ar, ct])
            out_phase = torch.where(pick_aud[:, None, None], pa[:, 1],
                                    pt[:, 1])
            vote = torch.where(pick_aud, 0, 1).to(torch.int32)
        # Seed chaining: within a window the next step continues from the
        # last appended code; across a window boundary the seed is the
        # num_frames_code-th kept code, at offset seed_off of the final
        # step's block (GestureKNN.py:789-802).
        is_last = t % n_steps == n_steps - 1
        prev_code = block[:, seed_off] if is_last else block[:, -1]
        prev_phase = out_phase
        blocks.append(block)
        phases.append(out_phase)
        votes.append(vote)
    flat = lambda xs: torch.stack(xs, 1).reshape((Q,) + xs[0].shape[1:])
    return flat(blocks), flat(phases), flat(votes)


def _solo_resets(Q: int, init_code, init_phase,
                 reset_mask: Optional[np.ndarray] = None,
                 reset_code: Optional[np.ndarray] = None,
                 reset_phase: Optional[np.ndarray] = None):
    """One clip's reset arrays with its initial seed as a reset at step 0
    (a reset already there wins, as it overrides the initial carry in the
    JAX scan). init_phase None is the zero phase."""
    mask = np.zeros((Q,), bool) if reset_mask is None else \
        np.array(reset_mask, bool)
    code = np.zeros((Q,), np.int64) if reset_code is None else \
        np.array(reset_code, np.int64)
    phase = np.zeros((Q, 8, 16), np.float32) if reset_phase is None else \
        np.array(reset_phase, np.float32)
    if not mask[0]:
        mask[0] = True
        code[0] = int(init_code)
        if init_phase is not None:
            phase[0] = init_phase
    return mask, code, phase


def _predict_impl(cfg: MatchConfig, n_steps: int, dev: DeviceDatabase,
                  devdb: DeviceMatchDB, test_audio, test_context,
                  rand_bits, reset_mask, reset_code, reset_phase,
                  clips: int = 1):
    """C clips (or streams): candidate tables for all their steps at once,
    then the lane-batched fused scan."""
    tables = _tables_impl(cfg, devdb, test_audio, test_context)
    return _fuse_scan_clips(cfg, n_steps, clips, dev, tables, rand_bits,
                            reset_mask, reset_code, reset_phase)


class CodeKNNEngine:
    """Device engine with the reference engine's semantics. All database
    tensors live on ``device`` for the engine's lifetime."""

    def __init__(self, cfg: MatchConfig, db: MatchDatabase,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.db = db
        self.device = resolve_device(device)
        dev = self.device
        # the fallback must use the same stable rank as the reference
        # oracle: freq_dist values collide heavily
        freq_rank = db.freq_rank if db.freq_rank is not None else \
            rank_np(db.freq_dist).astype(np.float32)
        grids = {}
        if cfg.use_phase:
            # one-time head/tail pair grids for the fusion scan
            phase = torch.as_tensor(db.phase, dtype=torch.float32, device=dev)
            amp = torch.as_tensor(db.amp, dtype=torch.float32, device=dev)
            for use, name, frames in ((cfg.use_aud, "aud_ht", db.aud_frames),
                                      (cfg.use_txt, "txt_ht", db.txt_frames)):
                if use:
                    grids[name] = _head_tail_grid(
                        phase, amp, _index_tensor(phase_start(frames), dev))
        self.dev = DeviceDatabase(
            sig_rank=rank(torch.as_tensor(db.sig_dist, dtype=torch.float32,
                                          device=dev)),
            freq_rank=torch.as_tensor(np.asarray(freq_rank).astype(np.int32),
                                      device=dev),
            **grids)
        self.devdb = device_match_db(cfg, db, dev)

    def _chain_inputs(self, W: int, S: int,
                      rng: np.random.RandomState):
        """Per-window re-seed resets and rand bits in the ORACLE's rng draw
        order: [rand w0, init w1, rand w1, init w2, ...] — the per-window
        init (non-chain modes, GestureKNN.py:797,804,806) interleaves with
        the per-window rand bits, so neither can be drawn in one block when
        both exist. Returns (rand_np, (reset_mask, reset_code,
        reset_phase))."""
        cfg = self.cfg
        needs_rand = not cfg.use_phase and cfg.use_aud and cfg.use_txt
        rand_np = np.zeros((W * S,), np.int32) if needs_rand else None
        reset = (None, None, None)
        if not cfg.chain_windows and W > 1:
            oracle = CodeKNNOracle(self.db)
            reset_mask = np.zeros((W * S,), bool)
            reset_code = np.zeros((W * S,), np.int32)
            reset_phase = np.zeros((W * S, 8, 16), np.float32)
            for w in range(W):
                if w > 0:
                    code_w, phase_w = oracle.init_code_phase(rng)
                    reset_mask[w * S] = True
                    reset_code[w * S] = code_w
                    if phase_w is not None:
                        reset_phase[w * S] = phase_w
                if needs_rand:
                    rand_np[w * S:(w + 1) * S] = \
                        (rng.rand(S) > 0.5).astype(np.int32)
            reset = (reset_mask, reset_code, reset_phase)
        elif needs_rand:
            rand_np = (rng.rand(W * S) > 0.5).astype(np.int32)
        return rand_np, reset

    def stage_queries(self, test_audio: Optional[np.ndarray],
                      test_context: Optional[np.ndarray]):
        """Host queries -> device tensors (None for an unused side), queued
        without a host sync."""
        cfg, dev = self.cfg, self.device
        ta = tc = None
        if cfg.use_aud:
            dtype = torch.int32 if cfg.audio_mode == "wavvq_feat" \
                else torch.float32
            ta = to_device(test_audio, dev, dtype)
        if cfg.use_txt:
            tc = to_device(test_context, dev, torch.float32)
        return ta, tc

    def predict_device(self, test_audio: Optional[np.ndarray],
                       test_context: Optional[np.ndarray] = None,
                       init_code: Optional[int] = None,
                       init_phase: Optional[np.ndarray] = None,
                       rng: Optional[np.random.RandomState] = None):
        """Device-resident variant: returns (codes (W, 30) int32, phases
        (Q, 8, 16), votes (Q,), (W, S)) as device tensors, for chaining
        straight into the VQ-VAE decode."""
        cfg = self.cfg
        rng = rng or np.random.RandomState(cfg.seed)
        if init_code is None:
            init_code, got_phase = CodeKNNOracle(self.db).init_code_phase(rng)
            if init_phase is None:
                init_phase = got_phase
        lead = test_audio if test_audio is not None else test_context
        W, S = lead.shape[:2]
        rand_np, reset = self._chain_inputs(W, S, rng)
        ta, tc = self.stage_queries(test_audio, test_context)
        blocks, phases, votes = _predict_impl(
            cfg, S, self.dev, self.devdb, ta, tc, rand_np,
            *_solo_resets(W * S, init_code, init_phase, *reset))
        codes = blocks.reshape(W, S * cfg.step_sz)[:, :cfg.num_frames_code]
        return codes.to(torch.int32), phases, votes, (W, S)

    def _result(self, codes: np.ndarray, phases: torch.Tensor,
                votes: torch.Tensor, W: int, S: int) -> OracleResult:
        """OracleResult of one clip from its host codes (W, 30) and its
        device phases (W*S, 8, 16) and votes (W*S,)."""
        cfg = self.cfg
        phases_np = None
        if cfg.use_phase:
            phases_np = phases.cpu().numpy().reshape(W, S, 8, 16)[:, -1]
        votes_np = votes.cpu().numpy().reshape(W, S) \
            if (cfg.use_phase and cfg.use_aud and cfg.use_txt) else None
        return OracleResult(codes=np.asarray(codes, np.int32),
                            phases=phases_np, votes=votes_np)

    def predict(self, test_audio: Optional[np.ndarray],
                test_context: Optional[np.ndarray] = None,
                init_code: Optional[int] = None,
                init_phase: Optional[np.ndarray] = None,
                rng: Optional[np.random.RandomState] = None) -> OracleResult:
        codes, phases, votes, (W, S) = self.predict_device(
            test_audio, test_context, init_code, init_phase, rng)
        return self._result(codes.cpu().numpy(), phases, votes, W, S)

    def _batch_inputs(self, C: int, W: int, S: int,
                      clip_audio: Optional[np.ndarray],
                      clip_context: Optional[np.ndarray],
                      init_codes: Optional[np.ndarray],
                      init_phases: Optional[np.ndarray],
                      rng: Optional[np.random.RandomState]):
        """Flattened queries + per-clip (and, for non-chaining configs,
        per-window) reset arrays + rand bits for a C-clip batch, all host
        arrays. The rng draws clip inits first, then the per-window
        re-seeds, then the rand bits (the JAX package's order)."""
        cfg = self.cfg
        rng = rng or np.random.RandomState(cfg.seed)
        oracle = CodeKNNOracle(self.db)
        if init_codes is None:
            draws = [oracle.init_code_phase(rng) for _ in range(C)]
            init_codes = np.array([d[0] for d in draws], np.int32)
            if cfg.use_phase and init_phases is None:
                init_phases = np.stack([d[1] for d in draws])
        if init_phases is None:
            init_phases = np.zeros((C, 8, 16), np.float32)

        Q = C * W * S
        reset_mask = np.zeros((Q,), bool)
        reset_code = np.zeros((Q,), np.int32)
        reset_phase = np.zeros((Q, 8, 16), np.float32)
        reset_mask[::W * S] = True
        reset_code[::W * S] = init_codes
        reset_phase[::W * S] = init_phases
        if not cfg.chain_windows:
            # non-chaining modes re-seed every window, not just every clip
            for c in range(C):
                for w in range(1, W):
                    code_w, phase_w = oracle.init_code_phase(rng)
                    q0 = (c * W + w) * S
                    reset_mask[q0] = True
                    reset_code[q0] = code_w
                    if phase_w is not None:
                        reset_phase[q0] = phase_w

        flat_audio = None if clip_audio is None else \
            clip_audio.reshape((C * W,) + clip_audio.shape[2:])
        flat_ctx = None if clip_context is None else \
            clip_context.reshape((C * W,) + clip_context.shape[2:])
        rand_bits = None
        if not cfg.use_phase and cfg.use_aud and cfg.use_txt:
            rand_bits = (rng.rand(Q) > 0.5).astype(np.int32)
        return (flat_audio, flat_ctx, reset_mask, reset_code, reset_phase,
                rand_bits)

    def _batch_unpack(self, blocks: torch.Tensor, phases: torch.Tensor,
                      votes: torch.Tensor, C: int, W: int, S: int) -> list:
        cfg = self.cfg
        codes = blocks.reshape(C, W, S * cfg.step_sz)[
            :, :, :cfg.num_frames_code].cpu().numpy()
        phases = phases.reshape(C, W * S, 8, 16)
        votes = votes.reshape(C, W * S)
        return [self._result(codes[c], phases[c], votes[c], W, S)
                for c in range(C)]

    def predict_batch(self, clip_audio: Optional[np.ndarray],
                      clip_context: Optional[np.ndarray] = None,
                      init_codes: Optional[np.ndarray] = None,
                      init_phases: Optional[np.ndarray] = None,
                      rng: Optional[np.random.RandomState] = None) -> list:
        """Batched serving: match C independent clips together.

        clip_audio: (C, W, S, ...) staged queries (same W per clip);
        init_codes: (C,) seeds (drawn like the reference when omitted).
        Phase 1 runs once over all C*W*S steps; the fusion scan runs the
        clips as C lanes of one loop (_fuse_scan_clips), each lane starting
        from its clip's reset. Returns a list of C OracleResults.

        The rng draws clip inits first, then per-window re-seeds for
        non-chaining configs, then rand bits (no-phase aud+txt mode):
        per-clip results equal sequential predict() when the inits (and
        bits) are passed explicitly, not when one rng is shared across both
        paths in the non-chaining or random-vote configurations."""
        cfg = self.cfg
        lead = clip_audio if clip_audio is not None else clip_context
        C, W, S = lead.shape[:3]
        (flat_audio, flat_ctx, reset_mask, reset_code, reset_phase,
         rand_bits) = self._batch_inputs(C, W, S, clip_audio, clip_context,
                                         init_codes, init_phases, rng)
        ta, tc = self.stage_queries(flat_audio, flat_ctx)
        blocks, phases, votes = _predict_impl(
            cfg, S, self.dev, self.devdb, ta, tc, rand_bits, reset_mask,
            reset_code, reset_phase, clips=C)
        return self._batch_unpack(blocks, phases, votes, C, W, S)

    # Serving buckets of the JAX package: clip lengths (in 4 s windows)
    # padded up to the next bucket so that XLA compiles one program per
    # bucket. Eager PyTorch compiles nothing, so here a bucket only pads.
    BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

    def predict_bucketed(self, test_audio: Optional[np.ndarray],
                         test_context: Optional[np.ndarray] = None,
                         init_code: Optional[int] = None,
                         init_phase: Optional[np.ndarray] = None,
                         rng: Optional[np.random.RandomState] = None,
                         buckets: Optional[tuple] = None) -> OracleResult:
        """predict() with the window count padded to a bucket, for callers
        of the JAX package's surface. The padding windows (copies of the
        last one) come after the real ones, so the seed chain through the
        real windows and their rng draws are untouched: results are
        identical to predict(). In eager PyTorch the padding saves no
        compile; it only costs the padded windows' work."""
        buckets = buckets or self.BUCKETS
        lead = test_audio if test_audio is not None else test_context
        W = lead.shape[0]
        Wb = next((b for b in buckets if b >= W), None)
        if Wb is None:  # beyond the largest bucket: round up to a multiple
            step = buckets[-1]
            Wb = ((W + step - 1) // step) * step

        def _pad(x):
            if x is None or Wb == W:
                return x
            return np.concatenate([x, np.repeat(x[-1:], Wb - W, axis=0)])

        codes, phases, votes, (_, S) = self.predict_device(
            _pad(test_audio), _pad(test_context), init_code, init_phase, rng)
        return self._result(codes[:W].cpu().numpy(), phases[:W * S],
                            votes[:W * S], W, S)
