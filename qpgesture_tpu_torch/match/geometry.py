"""Block/step geometry of the matching search.

The reference scans the database in blocks whose positions are generated by
float accumulation (``k += step_sz`` with step_sz = 398/30 in wavvq mode —
GestureKNN.py:673-690) and then truncates with int(). Those truncations are
semantically load-bearing (SURVEY §7 'hard parts' #2), so this module
reproduces the exact float64 accumulation on the host once, and the device
engine consumes the resulting static index tables.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..core import constants as C


def phase_start(frame_idx: np.ndarray) -> np.ndarray:
    """Phase window start per db frame k: int(k / 398 * 240) — the divisor
    is hard-coded 398 in the reference for every mode (GestureKNN.py:598).
    The single definition of this formula; the engine and sharded paths both
    consume it via their staged start tables."""
    return (np.asarray(frame_idx, dtype=np.float64) / C.WAVVQ_FRAMES
            * C.NUM_FRAMES).astype(np.int64)


@dataclass(frozen=True)
class ModeGeometry:
    """Static index tables for one audio mode."""
    mode: str
    n_db_frm: int
    step_sz: float
    # Database block tables (length B):
    block_code_idx: np.ndarray   # int(k / step_sz): index into code_train row
    block_frame_idx: np.ndarray  # int(k): frame index used for features/aux
    # Test-window step tables (length S, steps per 4 s window):
    step_clip_idx: np.ndarray    # int(i): index into the test clip
    step_context_idx: np.ndarray  # int(i / n_db_frm * 30): context slot

    def phase_start(self, frame_idx: np.ndarray) -> np.ndarray:
        return phase_start(frame_idx)


def _accumulate(step: float, stop: float) -> List[float]:
    ks = []
    k = 0.0
    while k < stop:
        ks.append(k)
        k += step
    return ks


def mode_geometry(mode: str, clip_len: int | None = None,
                  step_sz_codes: int = C.STEP_SZ,
                  num_frames_code: int = C.NUM_FRAMES_CODE,
                  num_frames: int = C.NUM_FRAMES) -> ModeGeometry:
    """Build the index tables for an audio mode.

    mode selects n_db_frm / step_sz exactly as CodeKNN.__init__
    (GestureKNN.py:431-443): wavlm modes use the interpolated frame count
    (180) with integer step 6; wavvq uses 398 with float step 398/30; mfcc
    modes use ``num_frames`` with step num_frames//num_frames_code — 240/8
    for 4 s windows, or the reference's long-window variant (e.g.
    num_frames=3600, num_frames_code=450: the constant.py edits implied by
    GestureKNN.py:853-854 / lmdb_to_noduplication.py:61).
    """
    if mode in ("wavlm", "wavlm_feat"):
        n_db_frm = (C.WAVLM_FRAMES // num_frames_code) * num_frames_code  # 180
        step = n_db_frm // num_frames_code                                # 6
    elif mode == "wavvq_feat":
        n_db_frm = C.WAVVQ_FRAMES                                         # 398
        step = n_db_frm / num_frames_code                                 # float
    elif mode in ("feat", "audio"):
        n_db_frm = num_frames                                             # 240
        step = num_frames // num_frames_code                              # 8
    else:
        raise ValueError(f"unknown audio mode {mode!r}")

    # Database block scan: while k < n_db_frm - STEP_SZ*step, k += step
    # (GestureKNN.py:673,690).
    ks = _accumulate(float(step), n_db_frm - step_sz_codes * float(step))
    block_code_idx = np.array([int(k / step) for k in ks], dtype=np.int64)
    block_frame_idx = np.array([int(k) for k in ks], dtype=np.int64)

    # Test steps: while i < len(clip), i += STEP_SZ*step (GestureKNN.py:528,
    # 659). len(clip) is n_db_frm for per-window search.
    clip_len = n_db_frm if clip_len is None else clip_len
    i_vals = _accumulate(step_sz_codes * float(step), float(clip_len))
    step_clip_idx = np.array([int(i) for i in i_vals], dtype=np.int64)
    step_context_idx = np.array(
        [int(i / n_db_frm * num_frames_code) for i in i_vals], dtype=np.int64)

    return ModeGeometry(mode=mode, n_db_frm=n_db_frm, step_sz=float(step),
                        block_code_idx=block_code_idx,
                        block_frame_idx=block_frame_idx,
                        step_clip_idx=step_clip_idx,
                        step_context_idx=step_context_idx)


def text_geometry(step_sz_codes: int = C.STEP_SZ) -> np.ndarray:
    """Text candidate slots: k in range(0, 240 - STEP_SZ*8, 8) -> code slot
    k//8 (GestureKNN.py:713-714). Returns (slots, frames) index arrays."""
    ks = np.arange(0, C.NUM_FRAMES - step_sz_codes * 8, 8, dtype=np.int64)
    return ks // 8, ks
