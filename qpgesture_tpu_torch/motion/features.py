"""Motion feature utilities (process/pymo/features.py equivalents).

The reference vendors plant/foot-contact detection (unused in its main path,
SURVEY §2.1); provided here for completeness: a joint is 'planted' in frames
where both its height and its velocity fall under thresholds. A copy of the
JAX package's ``motion/features.py`` (NumPy only).
"""
from __future__ import annotations

import numpy as np


def joint_velocity(positions: np.ndarray, fps: float = 60.0) -> np.ndarray:
    """(T, J, 3) world positions -> (T, J) speed in units/s (first frame
    repeats the second)."""
    vel = np.linalg.norm(np.diff(positions, axis=0), axis=2) * fps
    return np.concatenate([vel[:1], vel], axis=0)


def plant_frames(positions: np.ndarray, joint: int,
                 height_threshold: float, velocity_threshold: float,
                 fps: float = 60.0, up_axis: int = 1) -> np.ndarray:
    """(T,) bool mask of frames where `joint` is planted (low + still) —
    pymo create_foot_contact_idxs semantics."""
    height = positions[:, joint, up_axis]
    vel = joint_velocity(positions, fps)[:, joint]
    return (height < height_threshold) & (vel < velocity_threshold)


def reverse_time(values: np.ndarray) -> np.ndarray:
    """ReverseTime transform (preprocessing.py:1119): time-flipped copy for
    augmentation."""
    return values[::-1].copy()


def peak_indexes(y: np.ndarray, thres: float, min_dist: int,
                 thres_abs: bool = False) -> np.ndarray:
    """peakutils.indexes transcription (the dependency pymo's foot-contact
    code calls, features.py:13-14): local maxima above a threshold, with
    plateau handling and a min-distance suppression that keeps the highest
    peaks first."""
    y = np.asarray(y, dtype=np.float64)
    if not thres_abs:
        thres = thres * (np.max(y) - np.min(y)) + np.min(y)
    dy = np.diff(y)
    zeros, = np.where(dy == 0)
    if len(zeros) == len(y) - 1:
        return np.array([], dtype=np.int64)
    if len(zeros):
        # propagate edge slopes across zero plateaus so a flat top still
        # registers a single sign change
        zeros_diff = np.diff(zeros)
        split_at, = np.where(zeros_diff != 1)
        plateaus = np.split(zeros, split_at + 1)
        if plateaus and plateaus[0].size and plateaus[0][0] == 0:
            dy[plateaus[0]] = dy[plateaus[0][-1] + 1]
            plateaus.pop(0)
        if plateaus and plateaus[-1].size and \
                plateaus[-1][-1] == len(dy) - 1:
            dy[plateaus[-1]] = dy[plateaus[-1][0] - 1]
            plateaus.pop(-1)
        for plateau in plateaus:
            median = np.median(plateau)
            dy[plateau[plateau < median]] = dy[plateau[0] - 1]
            dy[plateau[plateau >= median]] = dy[plateau[-1] + 1]
    peaks = np.where((np.hstack([dy, 0.0]) < 0.0)
                     & (np.hstack([0.0, dy]) > 0.0)
                     & (y > thres))[0]
    if peaks.size > 1 and min_dist > 1:
        highest = peaks[np.argsort(y[peaks])][::-1]
        rem = np.ones(y.size, dtype=bool)
        rem[peaks] = False
        for peak in highest:
            if not rem[peak]:
                sl = slice(max(0, peak - min_dist), peak + min_dist + 1)
                rem[sl] = True
                rem[peak] = False
        peaks = np.arange(y.size)[~rem]
    return peaks.astype(np.int64)


def foot_contact_idxs(signal: np.ndarray, t: float = 0.02,
                      min_dist: int = 120):
    """get_foot_contact_idxs (pymo features.py:12-16): (up, down) peak
    index arrays over a height signal — note the reference's literal
    thresholds t/max(signal) and t/min(signal)."""
    signal = np.asarray(signal, np.float64)
    up = peak_indexes(signal, thres=t / max(signal), min_dist=min_dist)
    down = peak_indexes(-signal, thres=t / min(signal), min_dist=min_dist)
    return up, down


def foot_contact_signal(signal: np.ndarray, start: int = 1, t: float = 0.02,
                        min_dist: int = 120) -> np.ndarray:
    """create_foot_contact_signal (pymo features.py:19-34): a step signal
    that drops to 0 at each down peak (foot plant) and rises to 1 at each
    up peak."""
    up, down = foot_contact_idxs(signal, t, min_dist)
    up_set, down_set = set(up.tolist()), set(down.tolist())
    out = np.empty(len(signal), np.int64)
    c = start
    for f in range(len(signal)):
        if f in down_set:
            c = 0
        elif f in up_set:
            c = 1
        out[f] = c
    return out
