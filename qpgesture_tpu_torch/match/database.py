"""Matching database staging.

Builds the device-resident tensors the matching engine consumes, replacing
the reference's load_db_codebook (data_processing.py:197-353) + the per-step
Python re-scans (GestureKNN.py:666-721). All candidate tables are gathered
once per database: per (sequence, block) features, the code at each block,
the 4-code continuation block, and the phase windows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..core import constants as C
from ..core.config import MatchConfig
from ..core.schemas import CodebookSignature, DatabaseBundle
from ..ops.levenshtein import combine_wavvq
from ..ops.stacking import interpolate_linear, stack_post, stack_wavvq
from .geometry import ModeGeometry, mode_geometry, text_geometry


def calc_mean_std(x: np.ndarray):
    """Per-feature mean/std over sequences and frames
    (calc_data_stats, data_processing.py:172-182). x: (n, T, F)."""
    mean = x.mean(axis=(0, 1), dtype=np.float64)[None, :, None]
    std = x.std(axis=(0, 1), dtype=np.float64)[None, :, None]
    return mean.astype(np.float32), std.astype(np.float32)


def normalize(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """(x - mean) / (std + 1e-8) with (1, F, 1) stats broadcast over
    (n, F, T)-layout data (utils.py:8-9). Our data is (n, T, F), so stats are
    transposed accordingly."""
    return ((x - mean.transpose(0, 2, 1)) /
            (std.transpose(0, 2, 1) + 1e-8)).astype(np.float32)


@dataclass
class MatchDatabase:
    """Staged candidate tables for one speaker database + codebook."""
    cfg: MatchConfig
    geom: ModeGeometry
    code_train: np.ndarray          # (J, 30) int32
    signature: np.ndarray           # (512, 135) f32
    sig_dist: np.ndarray            # (512, 512) f32, +inf diagonal
    freq_dist: np.ndarray           # (512,) f32 rarity prior
    # Audio candidates per (sequence, block):
    aud_codes: np.ndarray           # (J, B) int32
    aud_blocks: np.ndarray          # (J, B, step_sz) int32 continuation codes
    aud_frames: np.ndarray          # (B,) int64 db frame index (aux k)
    # (512,) f32 double-argsort of freq_dist, reference tie order
    freq_rank: Optional[np.ndarray] = None
    aud_feat: Optional[np.ndarray] = None     # (J, B, D) f32 cosine modes
    aud_strings: Optional[np.ndarray] = None  # (J, B, L) int32 wavvq mode
    # Text candidates:
    txt_codes: Optional[np.ndarray] = None    # (J, 26) int32
    txt_blocks: Optional[np.ndarray] = None   # (J, 26, step_sz) int32
    txt_frames: Optional[np.ndarray] = None   # (26,) int64
    txt_feat: Optional[np.ndarray] = None     # (J, 26, 384) f32
    # Phase guidance:
    phase: Optional[np.ndarray] = None        # (J, 240, 8) f32
    amp: Optional[np.ndarray] = None          # (J, 240, 8) f32
    # Normalization stats reused for test features:
    stats: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def n_seq(self) -> int:
        return self.code_train.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.aud_codes.shape[1]


def code_frequency_prior(train_codes: np.ndarray,
                         codebook_size: int = C.CODEBOOK_SIZE) -> np.ndarray:
    """Rarity prior: 1 - count/total for codes present in the training codes,
    1.0 for unused codes (code_to_freq, GestureKNN.py:481-499)."""
    counts = np.bincount(train_codes.flatten().astype(np.int64),
                         minlength=codebook_size)
    total = counts.sum()
    freq = np.where(counts > 0, 1.0 - counts / max(total, 1), 1.0)
    return freq.astype(np.float32)


def frequency_rank(freq_dist: np.ndarray) -> np.ndarray:
    """The frequency prior's double-argsort rank, computed ONCE per database
    with NumPy's *default* (unstable) argsort so tie order matches the
    reference exactly (GestureKNN.py:544 — counts collide heavily, so this
    is the one rank where quicksort tie order is observable)."""
    return np.argsort(np.argsort(freq_dist)).astype(np.float32)


def signature_distance_table(signature: np.ndarray) -> np.ndarray:
    """(512, 512) pairwise Euclidean signature distances with +inf on the
    diagonal — the 'avoid staying in the same code' penalty
    (GestureKNN.py:531-536, the 1e10000 -> inf literal)."""
    sig = signature.astype(np.float32)
    d2 = ((sig[:, None, :] - sig[None, :, :]) ** 2).sum(-1)
    dist = np.sqrt(np.maximum(d2, 0.0)).astype(np.float32)
    np.fill_diagonal(dist, np.inf)
    return dist


def stage_database(cfg: MatchConfig,
                   bundle: DatabaseBundle,
                   codes: np.ndarray,
                   signature: CodebookSignature,
                   wavlm: Optional[np.ndarray] = None,
                   wavvq: Optional[np.ndarray] = None) -> MatchDatabase:
    """Stage a training database for matching.

    bundle: the *_txt_2.npz schema; codes: (J, 30); wavlm: (J, 199, 1024);
    wavvq: (J, 398, 2).
    """
    geom = mode_geometry(cfg.audio_mode, step_sz_codes=cfg.step_sz,
                         num_frames_code=cfg.num_frames_code,
                         num_frames=cfg.num_frames)
    code_train = codes.astype(np.int32)
    J = code_train.shape[0]
    B = len(geom.block_code_idx)

    stats: Dict[str, np.ndarray] = {}
    aud_feat = None
    aud_strings = None

    if cfg.audio_mode == "wavvq_feat":
        assert wavvq is not None
        sel = stack_wavvq(wavvq.astype(np.int32, copy=False),
                          frames=geom.block_frame_idx)       # (J, B, 22)
        if cfg.wavvq_mode == "sum":
            from ..ops.levenshtein import split_wavvq_groups
            g0, g1 = split_wavvq_groups(sel)                 # (J, B, 11) x2
            aud_strings = np.stack([g0, g1], axis=2)         # (J, B, 2, 11)
        else:
            aud_strings = combine_wavvq(sel)                 # (J, B, 11)
    elif cfg.audio_mode in ("wavlm_feat", "wavlm"):
        assert wavlm is not None
        interp = interpolate_linear(
            wavlm.astype(np.float32, copy=False),
            geom.n_db_frm)                                   # (J, 180, 1024)
        if cfg.audio_mode == "wavlm_feat":
            # the 6x stacked feature at block frame t is just frames
            # [t, t+2, ..., t+10] (all in range for block frames), so gather
            # directly instead of materializing the 6x-redundant full stack
            idx = (geom.block_frame_idx[:, None]
                   + (C.FRAME_INTERVAL - 2)
                   * np.arange(C.NUM_AUDIO_FEAT_FRAMES)[None, :])
            assert idx.max() < geom.n_db_frm
            aud_feat = interp[:, idx].reshape(J, B, -1)      # (J, B, 6144)
        else:
            # raw wavlm mode flattens step_sz consecutive frames per block
            step = int(geom.step_sz)
            idx = geom.block_frame_idx[:, None] + np.arange(step)[None, :]
            aud_feat = interp[:, idx].reshape(J, B, -1)
    elif cfg.audio_mode in ("feat", "audio"):
        mfcc = bundle.mfcc[:, :, :C.NUM_MFCC_FEAT].astype(np.float32)
        mean, std = calc_mean_std(mfcc)
        stats["mfcc_mean"], stats["mfcc_std"] = mean, std
        norm_mfcc = normalize(mfcc, mean, std)
        if cfg.audio_mode == "feat":
            # the reference stacks the RAW mfcc and normalizes the stacked
            # features with their own stats (GestureKNN.py:735-738)
            raw_feat = stack_post(mfcc, C.NUM_AUDIO_FEAT_FRAMES,
                                  C.FRAME_INTERVAL)          # (J, 240, 78)
            fmean, fstd = calc_mean_std(raw_feat)
            stats["feat_mean"], stats["feat_std"] = fmean, fstd
            feat = normalize(raw_feat, fmean, fstd)
            aud_feat = feat[:, geom.block_frame_idx]
        else:
            step = int(geom.step_sz)
            idx = geom.block_frame_idx[:, None] + np.arange(step)[None, :]
            aud_feat = norm_mfcc[:, idx].reshape(J, B, -1)
    else:
        raise ValueError(cfg.audio_mode)

    aud_codes = code_train[:, geom.block_code_idx]           # (J, B)
    blk_idx = (geom.block_code_idx[:, None] +
               np.arange(cfg.step_sz)[None, :])              # (B, step)
    aud_blocks = code_train[:, blk_idx]                      # (J, B, step)

    txt_codes = txt_blocks = txt_frames = txt_feat = None
    if cfg.use_txt:
        slots, frames = text_geometry(cfg.step_sz)
        # np.take is C-contiguous, so the device staging's reshape is a view
        txt_feat = np.take(bundle.context_2d, slots, axis=1).astype(
            np.float32, copy=False)                          # (J, 26, 384)
        txt_codes = code_train[:, slots]
        tb = slots[:, None] + np.arange(cfg.step_sz)[None, :]
        txt_blocks = code_train[:, tb]
        txt_frames = frames

    phase = amp = None
    if cfg.use_phase:
        dense = bundle.phase                                  # (J, T, 4, 8)
        phase = dense[:, :, 0, :].astype(np.float32)
        amp = dense[:, :, 2, :].astype(np.float32)

    freq_dist = code_frequency_prior(code_train, cfg.codebook_size)
    return MatchDatabase(
        cfg=cfg, geom=geom, code_train=code_train,
        signature=signature.signature.astype(np.float32),
        sig_dist=signature_distance_table(signature.signature),
        freq_dist=freq_dist,
        freq_rank=frequency_rank(freq_dist),
        aud_codes=aud_codes, aud_blocks=aud_blocks,
        aud_frames=geom.block_frame_idx,
        aud_feat=aud_feat, aud_strings=aud_strings,
        txt_codes=txt_codes, txt_blocks=txt_blocks, txt_frames=txt_frames,
        txt_feat=txt_feat, phase=phase, amp=amp, stats=stats)


def stage_test_audio(cfg: MatchConfig, db: MatchDatabase,
                     test_bundle: Optional[DatabaseBundle] = None,
                     wavlm: Optional[np.ndarray] = None,
                     wavvq: Optional[np.ndarray] = None,
                     clip_len: Optional[int] = None) -> np.ndarray:
    """Stage the per-step test audio queries.

    Returns (W, S, D) float32 features for cosine modes or (W, S, L) int32
    strings for the wavvq mode, where S = steps per window (8 for 4 s
    windows; pass clip_len for the reference's long-window variants, e.g.
    3600-frame mfcc clips — GestureKNN.py:853-854 — which walk more steps
    per window)."""
    geom = db.geom
    if clip_len is not None:
        geom = mode_geometry(cfg.audio_mode, clip_len=clip_len,
                             step_sz_codes=cfg.step_sz,
                             num_frames_code=cfg.num_frames_code,
                             num_frames=cfg.num_frames)
    sidx = geom.step_clip_idx
    if cfg.audio_mode == "wavvq_feat":
        assert wavvq is not None
        sel = stack_wavvq(wavvq.astype(np.int32, copy=False), frames=sidx)
        if cfg.wavvq_mode == "sum":
            from ..ops.levenshtein import split_wavvq_groups
            g0, g1 = split_wavvq_groups(sel)
            return np.stack([g0, g1], axis=2)                # (W, S, 2, 11)
        return combine_wavvq(sel)                            # (W, S, 11)
    if cfg.audio_mode in ("wavlm_feat", "wavlm"):
        assert wavlm is not None
        interp = interpolate_linear(wavlm.astype(np.float32), geom.n_db_frm)
        if cfg.audio_mode == "wavlm_feat":
            feat = stack_post(interp, C.NUM_AUDIO_FEAT_FRAMES,
                              C.FRAME_INTERVAL - 2)
            return feat[:, sidx]
        step = int(geom.step_sz)
        idx = sidx[:, None] + np.arange(step)[None, :]
        return interp[:, idx].reshape(interp.shape[0], len(sidx), -1)
    if cfg.audio_mode in ("feat", "audio"):
        mfcc = test_bundle.mfcc[:, :, :C.NUM_MFCC_FEAT].astype(np.float32)
        if cfg.audio_mode == "feat":
            raw_feat = stack_post(mfcc, C.NUM_AUDIO_FEAT_FRAMES,
                                  C.FRAME_INTERVAL)
            feat = normalize(raw_feat, db.stats["feat_mean"],
                             db.stats["feat_std"])
            return feat[:, sidx]
        norm_mfcc = normalize(mfcc, db.stats["mfcc_mean"],
                              db.stats["mfcc_std"])
        step = int(geom.step_sz)
        idx = sidx[:, None] + np.arange(step)[None, :]
        return norm_mfcc[:, idx].reshape(norm_mfcc.shape[0], len(sidx), -1)
    raise ValueError(cfg.audio_mode)


def stage_test_context(db: MatchDatabase,
                       context: np.ndarray) -> np.ndarray:
    """Per-step context queries: (W, 30, 384) -> (W, S, 384) via the
    int(i / n_db_frm * 30) slot mapping (GestureKNN.py:549-551)."""
    ctx = context.astype(np.float32)
    if ctx.ndim == 4:
        ctx = ctx.squeeze(2)
    return ctx[:, db.geom.step_context_idx]
