"""WORLD DIO + StoneMask pitch tracking, transcribed from the published
algorithm (M. Morise's WORLD vocoder: dio.cc / stonemask.cc).

The reference extracts pitch with `pyworld.dio` + `pyworld.stonemask`
(process/speech_feat.py:25-33, hop 256 @ 16 kHz -> frame_period 16 ms).
pyworld is a C++ dependency; this module is a from-scratch NumPy
transcription of the same algorithm so the stored database features match
the reference's semantics:

  DIO (dio.cc):
    * band-split the low-cut signal with Nuttall low-pass filters at
      boundary frequencies f0_floor * 2^((i+1)/channels_in_octave);
    * per band, estimate F0 from the four zero-crossing interval tracks
      (negative/positive crossings, peaks, dips) interpolated to the frame
      grid; candidate = mean, reliability = deviation of the four;
    * per frame keep the candidate with the best reliability, then fix the
      contour (step 1 rapid-change removal, step 2 short-voiced-section
      removal, steps 3/4 forward/backward extension over the candidate
      pool).
  StoneMask (stonemask.cc):
    * refine each voiced frame with the instantaneous frequencies of the
      first harmonics of a Blackman-windowed segment (3 periods), averaged
      with amplitude weights; corrections beyond 20 % are rejected.

Host-side and NumPy-only by design (prosody extraction is I/O-adjacent
preprocessing, SURVEY §2.9; the features are stored in the DB but unused
by the shipped scoring — GestureKNN.py:456).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

_EPS = 1e-12  # kMySafeGuardMinimum


def nuttall_window(n: int) -> np.ndarray:
    """Nuttall window as in WORLD's common.cc NuttallWindow (periodic-ish
    form over i in [0, n))."""
    t = np.arange(n) * (2.0 * np.pi / (n - 1))
    return (0.355768 - 0.487396 * np.cos(t) + 0.144232 * np.cos(2 * t)
            - 0.012604 * np.cos(3 * t))


def _low_cut_filter(y: np.ndarray, fs: int) -> np.ndarray:
    """Remove DC / very-low-frequency drift (dio.cc applies a 50 Hz low-cut
    before band analysis)."""
    n = int(round(fs / 50.0)) * 2 + 1
    w = nuttall_window(n)
    w /= w.sum()
    # high-pass = delta - low-pass
    lowpassed = np.convolve(y, w, mode="same")
    return y - lowpassed


def _filtered_signal(y: np.ndarray, fs: int,
                     boundary_f0: float) -> np.ndarray:
    """Low-pass the signal with a Nuttall window of length
    4*round(fs/boundary_f0/2) (dio.cc GetFilteredSignal) so only the band's
    fundamental survives."""
    half = int(round(fs / boundary_f0 / 2.0))
    lpf = nuttall_window(half * 4)
    lpf /= lpf.sum()
    return np.convolve(y, lpf, mode="same")


def _zero_crossings(sig: np.ndarray, fs: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Falling-edge zero crossings of sig (dio.cc ZeroCrossingEngine):
    returns (interval_locations [s], interval_f0s [Hz])."""
    s0 = sig[:-1]
    s1 = sig[1:]
    idx = np.where((s0 > 0) & (s1 <= 0))[0]
    if len(idx) < 3:
        return np.empty(0), np.empty(0)
    denom = s1[idx] - s0[idx]
    denom = np.where(np.abs(denom) < _EPS, _EPS, denom)
    fine = idx + s0[idx] / -denom  # linear-interpolated crossing sample
    intervals = np.diff(fine)
    f0s = fs / np.maximum(intervals, _EPS)
    locations = (fine[:-1] + fine[1:]) / 2.0 / fs
    return locations, f0s


def _four_interval_tracks(filtered: np.ndarray, fs: int) -> List:
    """The four event-interval tracks: negative crossings, positive
    crossings, peaks, dips (dio.cc GetFourZeroCrossingIntervals)."""
    d = np.diff(filtered)
    return [
        _zero_crossings(filtered, fs),          # negative-going crossings
        _zero_crossings(-filtered, fs),         # positive-going crossings
        _zero_crossings(d, fs),                 # peaks
        _zero_crossings(-d, fs),                # dips
    ]


def _interp_track(locations: np.ndarray, values: np.ndarray,
                  positions: np.ndarray) -> np.ndarray:
    if len(locations) < 2:
        return np.zeros_like(positions)
    return np.interp(positions, locations, values)


def _band_candidates(filtered: np.ndarray, fs: int, boundary_f0: float,
                     f0_floor: float, f0_ceil: float,
                     positions: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """F0 candidate + reliability score per frame for one band
    (dio.cc GetF0CandidateContour)."""
    tracks = _four_interval_tracks(filtered, fs)
    if any(len(loc) < 2 for loc, _ in tracks):
        return (np.zeros_like(positions),
                np.full_like(positions, np.finfo(np.float64).max / 4))
    interp = np.stack([_interp_track(loc, f0s, positions)
                       for loc, f0s in tracks])       # (4, T)
    cand = interp.mean(axis=0)
    dev = np.sqrt(((interp - cand) ** 2).sum(axis=0) / 3.0)
    score = dev / (cand + _EPS)
    bad = ((cand > boundary_f0) | (cand < boundary_f0 / 2.0)
           | (cand > f0_ceil) | (cand < f0_floor))
    cand = np.where(bad, 0.0, cand)
    score = np.where(bad, np.finfo(np.float64).max / 4, score)
    return cand, score


def _fix_step1(f0: np.ndarray, voice_range_minimum: int,
               allowed_range: float) -> np.ndarray:
    """Zero out boundary frames and rapid changes (dio.cc FixStep1)."""
    out = f0.copy()
    out[:voice_range_minimum] = 0.0
    out[-voice_range_minimum:] = 0.0
    prev = np.concatenate([[0.0], out[:-1]])
    rapid = np.abs(out - prev) / (out + _EPS) > allowed_range
    out = np.where(rapid, 0.0, out)
    return out


def _fix_step2(f0: np.ndarray, voice_range_minimum: int) -> np.ndarray:
    """Remove voiced sections shorter than voice_range_minimum
    (dio.cc FixStep2): a frame survives only if no zero exists within
    +-center frames."""
    center = (voice_range_minimum - 1) // 2
    if center == 0:
        return f0.copy()
    out = f0.copy()
    zero = f0 == 0.0
    bad = np.zeros_like(zero)
    for off in range(-center, center + 1):
        shifted = np.roll(zero, -off)
        if off > 0:
            shifted[-off:] = True
        elif off < 0:
            shifted[:-off] = True
        bad |= shifted
    out[bad] = 0.0
    out[:center] = 0.0
    out[-center:] = 0.0
    return out


def _select_best_f0(reference_f0: float, candidates: np.ndarray,
                    allowed_range: float) -> float:
    """Candidate (over bands) nearest the extrapolated reference
    (dio.cc SelectBestF0); 0 when nothing is within allowed_range."""
    errors = np.abs(candidates - reference_f0) / (reference_f0 + _EPS)
    errors = np.where(candidates > 0, errors, np.inf)
    i = int(np.argmin(errors))
    if errors[i] > allowed_range:
        return 0.0
    return float(candidates[i])


def _fix_step3(f0: np.ndarray, candidates: np.ndarray,
               allowed_range: float) -> np.ndarray:
    """Extend voiced sections forward over the candidate pool
    (dio.cc FixStep3)."""
    out = f0.copy()
    n = len(out)
    for i in range(1, n):
        if out[i] != 0.0 or out[i - 1] == 0.0:
            continue
        ref = out[i - 1] * 2.0 - (out[i - 2] if i >= 2 and out[i - 2] > 0
                                  else out[i - 1])
        j = i
        while j < n and out[j] == 0.0:
            best = _select_best_f0(ref, candidates[:, j], allowed_range)
            if best == 0.0:
                break
            prev = out[j - 1] if out[j - 1] > 0 else best
            out[j] = best
            ref = best * 2.0 - prev
            j += 1
    return out


def _fix_step4(f0: np.ndarray, candidates: np.ndarray,
               allowed_range: float) -> np.ndarray:
    """Backward extension (dio.cc FixStep4): mirror of step 3."""
    return _fix_step3(f0[::-1], candidates[:, ::-1],
                      allowed_range)[::-1]


def dio(x: np.ndarray, fs: int, f0_floor: float = 71.0,
        f0_ceil: float = 800.0, channels_in_octave: float = 2.0,
        frame_period: float = 5.0, allowed_range: float = 0.1
        ) -> Tuple[np.ndarray, np.ndarray]:
    """DIO F0 estimation (dio.cc DioGeneralBody).

    x: mono float waveform; frame_period in ms. Returns (f0, temporal
    positions in seconds); unvoiced frames are 0, like pyworld.dio."""
    x = np.asarray(x, np.float64)
    n_frames = int(1000.0 * len(x) / fs / frame_period) + 1
    positions = np.arange(n_frames) * frame_period / 1000.0

    y = _low_cut_filter(x - x.mean() if len(x) else x, fs)

    # dio.cc: number_of_bands = 1 + (int)(log2(ceil/floor) * cio) — 7 bands
    # at the defaults, top boundary ~803 Hz
    n_bands = 1 + int(np.log2(f0_ceil / f0_floor) * channels_in_octave)
    boundary_f0s = f0_floor * 2.0 ** ((np.arange(n_bands) + 1)
                                      / channels_in_octave)

    cands = np.zeros((n_bands, n_frames))
    scores = np.full((n_bands, n_frames), np.finfo(np.float64).max / 4)
    for b, bf0 in enumerate(boundary_f0s):
        filtered = _filtered_signal(y, fs, bf0)
        cands[b], scores[b] = _band_candidates(
            filtered, fs, bf0, f0_floor, f0_ceil, positions)

    best_band = np.argmin(scores, axis=0)
    best = cands[best_band, np.arange(n_frames)]

    voice_range_minimum = int(0.5 + 1000.0 / frame_period / f0_floor) * 2 + 1
    voice_range_minimum = min(voice_range_minimum, max(1, n_frames // 2))
    f0 = _fix_step1(best, voice_range_minimum, allowed_range)
    f0 = _fix_step2(f0, voice_range_minimum)
    f0 = _fix_step3(f0, cands, allowed_range)
    f0 = _fix_step4(f0, cands, allowed_range)
    return f0, positions


def _refine_frame(x: np.ndarray, fs: int, position: float,
                  f0: float) -> float:
    """StoneMask refinement of one voiced frame (stonemask.cc
    GetRefinedF0): instantaneous frequencies at the first harmonics of a
    Blackman-windowed 3-period segment, amplitude-weighted; corrections
    beyond 20 % are rejected."""
    if f0 <= 0.0:
        return 0.0
    half = int(np.ceil(3.0 * fs / f0 / 2.0))
    base_time = (np.arange(-half, half + 1)) / fs
    window_len_t = (2 * half + 1) / fs
    fft_size = 1 << int(np.ceil(np.log2(2 * half + 1)) + 1)

    idx = np.round((position + base_time) * fs).astype(np.int64)
    idx = np.clip(idx, 0, len(x) - 1)
    seg = x[idx]

    phase = 2.0 * np.pi * base_time / window_len_t
    main_w = 0.42 + 0.5 * np.cos(phase) + 0.08 * np.cos(2 * phase)
    diff_w = np.zeros_like(main_w)
    diff_w[1:-1] = -(main_w[2:] - main_w[:-2]) / 2.0
    diff_w[0] = -main_w[1] / 2.0
    diff_w[-1] = main_w[-2] / 2.0

    spec_main = np.fft.rfft(seg * main_w, fft_size)
    spec_diff = np.fft.rfft(seg * diff_w, fft_size)
    power = spec_main.real ** 2 + spec_main.imag ** 2
    numerator = (spec_main.real * spec_diff.imag
                 - spec_main.imag * spec_diff.real)
    bins = np.arange(len(power)) * fs / fft_size
    inst_freq = bins + numerator / np.maximum(power, _EPS) * fs \
        / (2.0 * np.pi)

    n_harm = min(int(fs / 2.0 / f0), 6)
    if n_harm < 1:
        return f0
    num = den = 0.0
    for k in range(1, n_harm + 1):
        j = int(round(f0 * k * fft_size / fs))
        if j <= 0 or j >= len(power):
            continue
        amp = np.sqrt(power[j])
        num += amp * inst_freq[j]
        den += amp * k
    if den <= _EPS:
        return f0
    refined = num / den
    if abs(refined - f0) / f0 > 0.2:
        return f0
    return float(refined)


def stonemask(x: np.ndarray, f0: np.ndarray, positions: np.ndarray,
              fs: int) -> np.ndarray:
    """StoneMask refinement of a DIO contour (pyworld.stonemask
    equivalent)."""
    x = np.asarray(x, np.float64)
    return np.array([_refine_frame(x, fs, t, v)
                     for v, t in zip(f0, positions)])


def get_pitch_world(wav: np.ndarray, sr: int = 16000, hop: int = 256,
                    log: bool = True, norm: bool = False,
                    eps: float = 1e-5, prefer_native: bool = True
                    ) -> np.ndarray:
    """pyworld-semantics pitch track, matching the reference's call
    (speech_feat.get_pitch:25-33): dio(frame_period=hop/sr*1000) +
    stonemask + optional log / z-norm.

    Uses the native C++ tracker (native/qpg_native.cpp qpg_pitch_world,
    ~30x the NumPy transcription on long recordings) when the library is
    built; the two are cross-verified in tests/test_native.py."""
    f0 = None
    if prefer_native:
        from ..utils.native import pitch_world_native
        f0 = pitch_world_native(wav, sr, frame_period=hop / sr * 1000.0)
    if f0 is None:
        f0, t = dio(wav, sr, frame_period=hop / sr * 1000.0)
        f0 = stonemask(wav, f0, t, sr)
    if log:
        f0 = np.log(np.maximum(eps, f0))
    if norm:
        f0 = (f0 - f0.mean()) / (f0.std() + _EPS)
    return f0.astype(np.float32)
