"""Database-sharded candidate search.

For a database past one card's memory (or to split phase 1's work), each
rank of a process group stages only its J-shard of the candidate features
(the sequence axis, padded to a multiple of the world size; padded rows
never match) and reduces it to per-code (min distance, first argmin). The
shards combine in two passes: all_reduce(MIN) of the mins, then
all_reduce(MIN) of each rank's global argmin where its min equals the
global one. The lowest global index wins a tie, which keeps the reference's
first-in-scan-order tie-break (GestureKNN.py:686-689) across shards, so
the combined tables are bit-equal to one device's. Only the small
code-continuation tables are replicated. The counterpart of
qpgesture_tpu/parallel/sharded_match.py, over a ProcessGroup in place of a
mesh; string distances go through the engine's ``string_distance_matrix``,
so K1 runs on each rank's shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import MatchConfig
from ..match.database import MatchDatabase
from ..match.engine import (DeviceTables, _index_tensor, _l2_normalize,
                            _stage_aud_feat, cosine_distance_prenorm,
                            segment_min_argmin, string_distance_matrix,
                            tables_from_minargs)
from ..match.geometry import phase_start
from .dist import all_reduce, pad_to_multiple, rank, world_size

_BIG = 2 ** 30


@dataclass
class ShardSide:
    """One side (audio or text) of a rank's share of the database."""
    feat: object            # staged as DeviceMatchDB.aud_feat / txt_feat
    codes: torch.Tensor     # (Js, B) i64, padded rows 0
    n_valid: int            # real rows of the shard (the rest is padding)
    offset: int             # global flat index of the shard's first row
    blocks: torch.Tensor    # (J, B, step) i64, the whole table
    starts: torch.Tensor    # (B,) i64 phase window starts


@dataclass
class ShardedMatchDB:
    aud: Optional[ShardSide]
    txt: Optional[ShardSide]


def _shard_rows(x: np.ndarray, world: int, r: int) -> Tuple[np.ndarray, int,
                                                             int]:
    """Rank r's rows of x's J axis padded to a multiple of the world size:
    (rows (Js, ...), real rows, Js). Only those rows are read, so x may be
    a memory-mapped file."""
    Js = -(-x.shape[0] // world)
    shard = np.asarray(x[r * Js:(r + 1) * Js])
    n_valid = shard.shape[0]
    if n_valid < Js:
        shard, _ = pad_to_multiple(shard, Js)
        if shard.shape[0] == 0:   # past the end: all padding
            shard = np.zeros((Js,) + x.shape[1:], x.dtype)
    return shard, n_valid, Js


def shard_match_db(cfg: MatchConfig, db: MatchDatabase,
                   device: torch.device, group=None) -> ShardedMatchDB:
    """Stage this rank's J-shard of each side on ``device``: features in the
    same residency as the single-device database (device_match_db), the
    shard's codes, and the whole continuation tables."""
    world, r = world_size(group), rank(group)

    def side(feat, codes, blocks, frames, stage):
        shard, n_valid, Js = _shard_rows(feat, world, r)
        codes_p, _ = pad_to_multiple(np.asarray(codes), world)
        B = codes.shape[1]
        return ShardSide(
            feat=stage(shard),
            codes=_index_tensor(codes_p[r * Js:(r + 1) * Js], device),
            n_valid=n_valid, offset=r * Js * B,
            blocks=_index_tensor(blocks, device),
            starts=_index_tensor(phase_start(frames), device))

    aud = txt = None
    if cfg.use_aud:
        if cfg.audio_mode == "wavvq_feat":
            aud = side(db.aud_strings, db.aud_codes, db.aud_blocks,
                       db.aud_frames, lambda s: torch.as_tensor(
                           s, dtype=torch.int32, device=device))
        else:
            aud = side(db.aud_feat, db.aud_codes, db.aud_blocks,
                       db.aud_frames, lambda s: _stage_aud_feat(
                           cfg, s.reshape(-1, s.shape[-1]), device))
    if cfg.use_txt:
        txt = side(db.txt_feat, db.txt_codes, db.txt_blocks, db.txt_frames,
                   lambda s: _l2_normalize(torch.as_tensor(
                       s.reshape(-1, s.shape[-1]), dtype=torch.float32,
                       device=device)))
    return ShardedMatchDB(aud=aud, txt=txt)


def shard_minargs(cfg: MatchConfig, q: torch.Tensor, side: ShardSide,
                  is_strings: bool):
    """One rank's per-code reduction of its shard: (mins (Q, K) with inf
    where unmatched, global flat argmins (Q, K) with 2**30 where
    unmatched). Only the shard's real rows are scored: padded rows never
    match."""
    n = side.n_valid * side.codes.shape[1]
    if is_strings:
        d = string_distance_matrix(q, side.feat[:side.n_valid])
    elif isinstance(side.feat, tuple):      # the bf16 split (hi, lo)
        d = cosine_distance_prenorm(q, tuple(f[:n] for f in side.feat))
    else:
        d = cosine_distance_prenorm(q, side.feat[:n])
    mins, args, matched = segment_min_argmin(
        d, side.codes.reshape(-1)[:n], cfg.codebook_size, cfg.unmatched_dist)
    return (torch.where(matched, mins, torch.full_like(mins, float("inf"))),
            torch.where(matched, args + side.offset,
                        torch.full_like(args, _BIG)))


def combine_minargs(cfg: MatchConfig, mins: torch.Tensor, args: torch.Tensor,
                    group=None):
    """The two-pass cross-rank combine of shard_minargs' output: (mins
    (unmatched_dist where no rank matched), args (0 there), matched), equal
    on every rank to one device's segment_min_argmin over the whole
    database."""
    gmin = all_reduce(mins, "min", group)
    garg = all_reduce(torch.where(mins == gmin, args,
                                  torch.full_like(args, _BIG)), "min", group)
    matched = torch.isfinite(gmin)
    return (torch.where(matched, gmin,
                        torch.full_like(gmin, cfg.unmatched_dist)),
            torch.where(matched, garg, torch.zeros_like(garg)), matched)


def build_sharded_tables(cfg: MatchConfig, sdb: ShardedMatchDB,
                         test_audio: Optional[torch.Tensor],
                         test_context: Optional[torch.Tensor],
                         group=None) -> DeviceTables:
    """Sharded-database version of engine._tables_impl: identical tables on
    every rank, J-sharded distance work."""
    out = {}
    n_steps = 0
    for name, side, queries, is_str in (
            ("aud", sdb.aud, test_audio, cfg.audio_mode == "wavvq_feat"),
            ("txt", sdb.txt, test_context, False)):
        if side is None:
            out[name] = (None,) * 4
            continue
        W, n_steps = queries.shape[:2]
        q = queries.reshape(W * n_steps, *queries.shape[2:])
        if name == "txt":
            q = q.reshape(W * n_steps, -1)
        mins, args = shard_minargs(cfg, q, side, is_str)
        out[name] = tables_from_minargs(
            cfg, *combine_minargs(cfg, mins, args, group), side.blocks,
            side.starts)
    return DeviceTables(*out["aud"], *out["txt"], n_steps=n_steps)


def sharded_min_reduce_demo(group=None, device: torch.device = torch.device(
        "cpu")) -> None:
    """Self-check: the sharded reduction of a tiny cosine database equals
    one device's reduction."""
    rng = np.random.RandomState(0)
    cfg = MatchConfig(codebook_size=16, use_txt=False, use_phase=False)
    J, B, D, Q = 8, 4, 32, 3
    feat = rng.randn(J, B, D).astype(np.float32)
    codes = rng.randint(0, 16, size=(J, B)).astype(np.int32)
    q = torch.as_tensor(rng.randn(Q, D).astype(np.float32), device=device)
    world, r = world_size(group), rank(group)
    shard, n_valid, Js = _shard_rows(feat, world, r)
    codes_p, _ = pad_to_multiple(codes, world)
    side = ShardSide(
        feat=_l2_normalize(torch.as_tensor(shard.reshape(-1, D),
                                           device=device)),
        codes=torch.as_tensor(codes_p[r * Js:(r + 1) * Js], dtype=torch.int64,
                              device=device),
        n_valid=n_valid, offset=r * Js * B, blocks=None, starts=None)
    mins, args, matched = combine_minargs(
        cfg, *shard_minargs(cfg, q, side, False), group)
    full = _l2_normalize(torch.as_tensor(feat.reshape(-1, D), device=device))
    ref_m, ref_a, ref_ok = segment_min_argmin(
        cosine_distance_prenorm(q, full),
        torch.as_tensor(codes.reshape(-1), dtype=torch.int64, device=device),
        16, cfg.unmatched_dist)
    assert torch.equal(matched, ref_ok)
    torch.testing.assert_close(mins, ref_m, atol=1e-5, rtol=0)
    assert torch.equal(args[ref_ok], ref_a[ref_ok])
