"""QPGesture's code matching (Yang et al., CVPR 2023; ``GestureKNN.py``'s
``CodeKNN`` with phase, text and audio guidance) in plain PyTorch and
NumPy, written from the reference's semantics:

  * the database staging: per (sequence, block) audio features or wavvq
    strings, the code of each block and its 4-code continuation, the text
    slots, the phase and amplitude channels, the signature distances and
    the frequency prior (``data_processing.py``, ``GestureKNN.py:431-499``);
  * the per-step queries of a window (interpolated, stacked WavLM frames;
    two-sided stacked vq-wav2vec strings; context slots);
  * the per-step, per-code candidate tables: the first minimum in scan
    order of the cosine or edit distance for each code
    (``GestureKNN.py:666-721``);
  * the fusion of a window: rank sums of the signature distance, the
    frequency prior and the candidate distance, the audio and text top-1
    settled by phase continuity, the seed code and phase chained from step
    to step and from window to window (``GestureKNN.py:501-664, 789-802``).

Ranks are stable (ties in index order) and the frequency term is summed as
integers (1 / freq_weight times each rank): the exact form of the
reference's float sums. The frequency prior's own rank keeps NumPy's
default sort, the reference's tie order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

NUM_FRAMES = 240          # pose frames a 4 s window holds
NUM_CODES = 30            # codes a window holds
STEP_CODES = 4            # codes a step appends
WAVVQ_FRAMES = 398        # vq-wav2vec frames of a window
WAVVQ_VOCAB = 320
STACK = 6                 # stacked frames of an audio feature
WAVLM_INTERVAL = 2        # frame interval of the stacked WavLM feature


def _accumulate(step: float, stop: float) -> List[float]:
    ks, k = [], 0.0
    while k < stop:
        ks.append(k)
        k += step
    return ks


@dataclass(frozen=True)
class Geometry:
    n_frames: int                 # audio frames a window is matched over
    block_code: np.ndarray        # (B,) code index of each database block
    block_frame: np.ndarray       # (B,) audio frame of each database block
    step_frame: np.ndarray        # (S,) audio frame of each query step
    step_slot: np.ndarray         # (S,) context slot of each query step


def geometry(audio_mode: str, wavlm_frames: int = 199) -> Geometry:
    """Block and step positions by the reference's float accumulation and
    int() truncation."""
    if audio_mode == "wavlm_feat":
        n = (wavlm_frames // NUM_CODES) * NUM_CODES
        step = float(n // NUM_CODES)
    elif audio_mode == "wavvq_feat":
        n = WAVVQ_FRAMES
        step = n / NUM_CODES
    else:
        raise ValueError(f"audio mode {audio_mode!r} is not benchmarked")
    ks = _accumulate(step, n - STEP_CODES * step)
    steps = _accumulate(STEP_CODES * step, float(n))
    return Geometry(
        n_frames=n,
        block_code=np.array([int(k / step) for k in ks], np.int64),
        block_frame=np.array([int(k) for k in ks], np.int64),
        step_frame=np.array([int(i) for i in steps], np.int64),
        step_slot=np.array([int(i / n * NUM_CODES) for i in steps],
                           np.int64))


def text_slots() -> Tuple[np.ndarray, np.ndarray]:
    """(slots, frames) of the text candidates: every 8th pose frame below
    240 - 32."""
    frames = np.arange(0, NUM_FRAMES - STEP_CODES * 8, 8, dtype=np.int64)
    return frames // 8, frames


def _normalize(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.where(n > 0, n, torch.ones_like(n))


def interpolate(x: torch.Tensor, size: int) -> torch.Tensor:
    """(n, T, F) -> (n, size, F), linear with aligned corners, float32
    weights, x[lo] * (1 - w) + x[lo + 1] * w."""
    T = x.shape[1]
    coords = np.arange(size, dtype=np.float64) * (T - 1) / (size - 1)
    lo = np.clip(np.floor(coords).astype(np.int64), 0, T - 2)
    w = (coords - lo).astype(np.float32)
    lo_t = torch.as_tensor(lo, device=x.device)
    one_minus = torch.as_tensor(np.float32(1.0) - w, device=x.device)
    w = torch.as_tensor(w, device=x.device)
    return (x[:, lo_t] * one_minus[None, :, None]
            + x[:, lo_t + 1] * w[None, :, None])


def wavvq_strings(codes: torch.Tensor, frames: np.ndarray) -> torch.Tensor:
    """(n, 398, 2) vq-wav2vec codes -> (n, len(frames), 11) int64 strings at
    ``frames``: 6 past-aligned and 5 future frames at the interval 398/30,
    zero past either end, each frame one symbol g0 * 320 + g1."""
    T = codes.shape[1]
    fi = T / NUM_CODES
    shifts = [-int((STACK - 1 - i) * fi) for i in range(STACK)] \
        + [int(j * fi) for j in range(1, STACK)]
    idx = frames[:, None] + np.array(shifts)[None, :]         # (F, 11)
    valid = torch.as_tensor((idx >= 0) & (idx < T), device=codes.device)
    sel = codes[:, torch.as_tensor(np.clip(idx, 0, T - 1),
                                   device=codes.device)].long()  # (n,F,11,2)
    sym = sel[..., 0] * WAVVQ_VOCAB + sel[..., 1]
    return torch.where(valid[None], sym, torch.zeros_like(sym))


def wavlm_stack(feats: torch.Tensor, frames: np.ndarray,
                n_frames: int) -> torch.Tensor:
    """(n, 199, D) features -> (n, len(frames), 6 D): interpolated to
    n_frames, then frames t, t + 2, ..., t + 10, zero past the end."""
    interp = interpolate(feats, n_frames)
    idx = frames[:, None] + WAVLM_INTERVAL * np.arange(STACK)[None, :]
    valid = torch.as_tensor(idx < n_frames, device=feats.device)
    sel = interp[:, torch.as_tensor(np.clip(idx, 0, n_frames - 1),
                                    device=feats.device)]    # (n, F, 6, D)
    sel = torch.where(valid[None, :, :, None], sel, torch.zeros_like(sel))
    return sel.reshape(sel.shape[0], sel.shape[1], -1)


def signature_distance(signature: np.ndarray) -> np.ndarray:
    """(512, 512) Euclidean distances of the code signatures, +inf on the
    diagonal."""
    sig = signature.astype(np.float32)
    d = np.sqrt(np.maximum(((sig[:, None, :] - sig[None, :, :]) ** 2
                            ).sum(-1), 0.0)).astype(np.float32)
    np.fill_diagonal(d, np.inf)
    return d


def frequency_prior(codes: np.ndarray, k: int) -> np.ndarray:
    counts = np.bincount(codes.reshape(-1).astype(np.int64), minlength=k)
    total = counts.sum()
    return np.where(counts > 0, 1.0 - counts / max(total, 1),
                    1.0).astype(np.float32)


def stable_rank(x: np.ndarray) -> np.ndarray:
    order = np.argsort(x, kind="stable")
    r = np.empty_like(order)
    r[order] = np.arange(x.shape[-1])
    return r


@dataclass
class Side:
    """One candidate side of the staged database on the device."""
    feat: torch.Tensor            # (N, D) normalized float32, or (N, L) strings
    codes: torch.Tensor           # (N,) code of each candidate
    blocks: np.ndarray            # (N, 4) continuation codes (host)
    seq: np.ndarray               # (N,) sequence of each candidate
    frame: np.ndarray             # (N,) audio frame of each candidate


@dataclass
class Database:
    cfg: dict
    geom: Geometry
    aud: Side
    txt: Side
    phase: np.ndarray             # (J, 240, 8)
    amp: np.ndarray               # (J, 240, 8)
    sig_dist: np.ndarray          # (512, 512)
    freq_rank: np.ndarray         # (512,) int64


def stage_database(cfg: dict, codes: np.ndarray, context: np.ndarray,
                   phase: np.ndarray, signature: np.ndarray,
                   audio: np.ndarray, device) -> Database:
    """The staged candidates of a speaker database. codes (J, 30); context
    (J, 30, 384); phase (J, 240, 4, 8) [phase, freq, amplitude, offset];
    signature (512, 135); audio: WavLM features (J, 199, D) or vq-wav2vec
    codes (J, 398, 2)."""
    mode = cfg["audio_mode"]
    geom = geometry(mode, audio.shape[1] if mode == "wavlm_feat" else 199)
    J = codes.shape[0]
    B = len(geom.block_code)
    blk = geom.block_code[:, None] + np.arange(STEP_CODES)[None, :]
    if mode == "wavlm_feat":
        feat = _normalize(wavlm_stack(
            torch.as_tensor(audio, device=device), geom.block_frame,
            geom.n_frames).reshape(J * B, -1))
    else:
        feat = wavvq_strings(torch.as_tensor(audio, device=device),
                             geom.block_frame).reshape(J * B, -1)
    aud = Side(feat=feat,
               codes=torch.as_tensor(codes[:, geom.block_code].reshape(-1),
                                     device=device),
               blocks=codes[:, blk].reshape(J * B, STEP_CODES),
               seq=np.repeat(np.arange(J), B),
               frame=np.tile(geom.block_frame, J))
    slots, frames = text_slots()
    S = len(slots)
    tblk = slots[:, None] + np.arange(STEP_CODES)[None, :]
    txt = Side(feat=_normalize(torch.as_tensor(
                   context[:, slots].reshape(J * S, -1), device=device)),
               codes=torch.as_tensor(codes[:, slots].reshape(-1),
                                     device=device),
               blocks=codes[:, tblk].reshape(J * S, STEP_CODES),
               seq=np.repeat(np.arange(J), S),
               frame=np.tile(frames, J))
    freq = frequency_prior(codes, cfg["codebook_size"])
    return Database(cfg=cfg, geom=geom, aud=aud, txt=txt,
                    phase=np.ascontiguousarray(phase[:, :, 0]),
                    amp=np.ascontiguousarray(phase[:, :, 2]),
                    sig_dist=signature_distance(signature),
                    freq_rank=np.argsort(np.argsort(freq)))


def stage_audio_queries(db: Database, enc: torch.Tensor) -> torch.Tensor:
    """Encoder output of W windows -> (W * S, ...) per-step queries:
    float32 features (WavLM) or int64 strings (vq-wav2vec codes)."""
    g = db.geom
    if db.cfg["audio_mode"] == "wavlm_feat":
        q = wavlm_stack(enc.float(), g.step_frame, g.n_frames)
    else:
        q = wavvq_strings(enc, g.step_frame)
    return q.reshape(-1, q.shape[-1])


def stage_context_queries(db: Database, context: torch.Tensor
                          ) -> torch.Tensor:
    """(W, 30, 384) context -> (W * S, 384)."""
    q = context.float()[:, torch.as_tensor(db.geom.step_slot,
                                           device=context.device)]
    return q.reshape(-1, q.shape[-1])


def edit_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, L) x (N, L) strings -> (Q, N) int32 Levenshtein distances, the
    DP row by row over all pairs at once."""
    Q, L = a.shape
    N = b.shape[0]
    row = [torch.full((Q, N), j, dtype=torch.int32, device=a.device)
           for j in range(L + 1)]
    for i in range(1, L + 1):
        new = [torch.full((Q, N), i, dtype=torch.int32, device=a.device)]
        ai = a[:, i - 1:i]
        for j in range(1, L + 1):
            sub = row[j - 1] + (ai != b[None, :, j - 1]).to(torch.int32)
            new.append(torch.minimum(torch.minimum(row[j], new[j - 1]) + 1,
                                     sub))
        row = new
    return row[L]


@dataclass
class Tables:
    """Per query, per code: the best distance, and the winning candidate's
    flat index (-1 where the code never occurs)."""
    dist: np.ndarray              # (Q, K) float32
    index: np.ndarray             # (Q, K) int64


def candidate_tables(side: Side, queries: torch.Tensor, k: int,
                     unmatched: float, strings: bool,
                     chunk: int = 64) -> Tables:
    """First minimum in scan order per code of each query's distances to
    every candidate of ``side``."""
    N = side.codes.shape[0]
    seg = side.codes.long()
    dists, idxs = [], []
    for s in range(0, queries.shape[0], chunk):
        q = queries[s:s + chunk]
        if strings:
            d = edit_distance(q, side.feat).float()
        else:
            d = 1.0 - _normalize(q) @ side.feat.T
        seg_q = seg.expand(d.shape[0], N)
        best = torch.full((d.shape[0], k), float("inf"), device=d.device
                          ).scatter_reduce(1, seg_q, d, "amin",
                                           include_self=True)
        first = torch.where(d == best.gather(1, seg_q),
                            torch.arange(N, device=d.device).expand_as(d), N)
        idx = torch.full((d.shape[0], k), N, dtype=torch.int64,
                         device=d.device).scatter_reduce(
            1, seg_q, first, "amin", include_self=True)
        hit = idx < N
        dists.append(torch.where(hit, best, torch.full_like(best, unmatched)
                                 ).cpu().numpy())
        idxs.append(torch.where(hit, idx, -1).cpu().numpy())
    return Tables(np.concatenate(dists), np.concatenate(idxs))


def _phase_window(db: Database, side: Side, i: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(head, tail) (8, 16) of the 32-frame phase window of candidate i:
    start int(frame / 398 * 240)."""
    start = int(side.frame[i] / WAVVQ_FRAMES * NUM_FRAMES)
    ph = db.phase[side.seq[i], start:start + 32]
    am = db.amp[side.seq[i], start:start + 32]
    return (np.concatenate((ph[:8], am[:8]), 1),
            np.concatenate((ph[-8:], am[-8:]), 1))


def _tree_sum(x: np.ndarray) -> np.float32:
    """Sum of a float32 vector as a fixed binary tree of adds: the halves
    added elementwise level by level (at an odd length the last entry is
    added into the first). Every IEEE operation is fixed in order, so the
    sum is the same wherever it runs, and a comparison of two sums that lie
    within rounding of each other comes out the same on both sides."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    while n > 1:
        h = n // 2
        head = x[:h] + x[h:2 * h]
        if n % 2:
            head[0] += x[2 * h]
        x, n = head, h
    return x[0]


def _cos_dist(a: np.ndarray, b: np.ndarray) -> np.float32:
    """1 - cos(a, b) in float32, each sum over a fixed tree (_tree_sum)."""
    na = np.sqrt(_tree_sum(a * a))
    nb = np.sqrt(_tree_sum(b * b))
    na = na if na > 0 else np.float32(1.0)
    nb = nb if nb > 0 else np.float32(1.0)
    return np.float32(np.float32(1.0) - _tree_sum((a / na) * (b / nb)))


def _continuity(prev: np.ndarray, head: np.ndarray) -> np.float32:
    a = np.concatenate((prev[-5:], head[:3]), 0).reshape(-1)
    b = np.concatenate((prev[-3:], head[:5]), 0).reshape(-1)
    return _cos_dist(a, b)


def _block(side: Side, idx: int, code: int) -> np.ndarray:
    """Continuation of the winning candidate; a code never matched repeats
    itself."""
    return side.blocks[idx] if idx >= 0 else np.full(STEP_CODES, code)


def fuse(db: Database, aud: Tables, txt: Tables, q0: int, n_windows: int,
         code: int, phase: np.ndarray):
    """The fusion of n_windows windows whose steps are rows q0, q0 + 1, ...
    of the tables, from the seed (code, phase (8, 16)). Phase, text and
    audio guidance (the benchmarked presets). Returns (codes (W, 30),
    phases (W, 8, 16): each window's final phase)."""
    cfg = db.cfg
    if not (cfg["use_phase"] and cfg["use_aud"] and cfg["use_txt"]):
        raise ValueError("the reference fuses phase + text + audio only")
    scale = int(round(1.0 / cfg["freq_weight"]))
    S = len(db.geom.step_frame)
    codes_out, phases_out = [], []
    q = q0
    phase = np.asarray(phase, np.float32)
    for _ in range(n_windows):
        result = [int(code)]
        for _ in range(S):
            pos = stable_rank(db.sig_dist[result[-1]]) * scale \
                + db.freq_rank
            ca = int(np.argmin(pos + stable_rank(aud.dist[q]) * scale))
            ct = int(np.argmin(pos + stable_rank(txt.dist[q]) * scale))
            ia, it = int(aud.index[q, ca]), int(txt.index[q, ct])
            head_a, tail_a = _phase_window(db, db.aud, max(ia, 0))
            head_t, tail_t = _phase_window(db, db.txt, max(it, 0))
            if _continuity(phase, head_a) <= _continuity(phase, head_t):
                result.extend(int(c) for c in _block(db.aud, ia, ca))
                phase = tail_a
            else:
                result.extend(int(c) for c in _block(db.txt, it, ct))
                phase = tail_t
            q += 1
        window = np.array(result[1:1 + NUM_CODES], np.int64)
        codes_out.append(window)
        phases_out.append(phase)
        code = int(window[-1])
    return np.stack(codes_out), np.stack(phases_out)
