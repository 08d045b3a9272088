"""Context-frame stacking and interpolation for the matching database.

Reproduces the feature staging in
codebook/Speech2GestureMatching/data_processing.py:197-353:

  * post-padded stacks: feature at frame t is the concatenation of frames
    [t, t+I, t+2I, ...] (future context), zero-padded past the end — used for
    MFCC (I=4, 6 frames -> 78 dims), prosody (I=4, 6 frames -> 18 dims) and
    WavLM (I=2, 6 frames -> 6144 dims);
  * the wavvq two-sided stack: 6 past-aligned + 5 future frames with
    fractional interval 398/30, concatenated to 22 dims per position
    (data_processing.py:296-335);
  * linear interpolation of WavLM features 199 -> 180 frames matching
    torch.nn.functional.interpolate(..., align_corners=True)
    (data_processing.py:258-261).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def stack_post(x: np.ndarray, n_stack: int, interval: int) -> np.ndarray:
    """(n, T, F) -> (n, T, n_stack*F): frame t gets [t, t+I, ...], zero-padded.

    Matches the audio_feat loops at data_processing.py:208-212 (and the
    equivalent loops for prosody and WavLM features).
    """
    n, T, F = x.shape
    out = np.zeros((n, T, n_stack, F), dtype=x.dtype)
    for i in range(n_stack):
        shift = min(i * interval, T)  # shift > T: the whole plane is pad
        out[:, : T - shift, i, :] = x[:, shift:, :]
    return out.reshape(n, T, n_stack * F)


def wavvq_shifts(T: int, n_stack: int = 6,
                 num_frames_code: int = 30) -> np.ndarray:
    """The 11 two-sided stacking shifts of stack_wavvq: frame t slot s reads
    codes[t + shifts[s]] (zero where out of range)."""
    fi = T / num_frames_code  # fractional frame interval (398/30)
    past = [-int((n_stack - 1 - i) * fi) for i in range(n_stack)]
    future = [int(j * fi) for j in range(1, n_stack)]
    return np.array(past + future, dtype=np.int64)


def stack_wavvq(wavvq: np.ndarray, n_stack: int = 6,
                num_frames_code: int = 30,
                frames: Optional[np.ndarray] = None) -> np.ndarray:
    """(n, 398, 2) int codes -> (n, 398, 22) two-sided stacked features, or
    (n, len(frames), 22) at the positions ``frames`` alone.

    Matches the '20221101' two-sided construction at
    data_processing.py:296-335: part 1 right-shifts by
    int((n_stack-i-1) * 398/30) for i in 0..5 (6 past-aligned frames,
    current frame last); part 2 left-shifts by int(i * 398/30) for i in 1..5
    (5 future frames; the i=0 duplicate of the current frame is dropped).
    Zero padding everywhere a shift runs off the sequence. Each position is
    gathered on its own, so staging that keeps a few frames stacks only
    those.
    """
    n, T, G = wavvq.shape
    frames = np.arange(T) if frames is None else np.asarray(frames)
    src = frames[:, None] + wavvq_shifts(T, n_stack, num_frames_code)
    out = np.take(wavvq, np.clip(src, 0, T - 1), axis=1)  # (n, F, 11, G)
    out[:, (src < 0) | (src >= T)] = 0
    return out.reshape(n, len(frames), -1)


def interpolate_linear(x: np.ndarray, size: int) -> np.ndarray:
    """(n, T, F) -> (n, size, F) linear interpolation along T, matching
    torch F.interpolate(mode='linear', align_corners=True)."""
    n, T, F = x.shape
    if size == T:
        return x.copy()
    if size == 1:
        return x[:, :1].copy()
    # align_corners=True: output index t maps to input coord t*(T-1)/(size-1)
    coords = np.arange(size, dtype=np.float64) * (T - 1) / (size - 1)
    lo = np.floor(coords).astype(np.int64)
    lo = np.clip(lo, 0, T - 2)
    w = (coords - lo).astype(x.dtype if x.dtype.kind == "f" else np.float64)
    out = x[:, lo] * (1 - w)[None, :, None] + x[:, lo + 1] * w[None, :, None]
    return out.astype(x.dtype if x.dtype.kind == "f" else np.float64,
                      copy=False)
