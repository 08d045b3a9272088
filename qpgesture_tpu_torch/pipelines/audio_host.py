"""Host prosody features: energy, pitch, volume.

Port of process/speech_feat.py:13-103 without librosa/pyworld:
  * energy: |STFT| -> slaney mel bank (80 mels, 80-7600 Hz) -> log10 ->
    sqrt(sum(exp(mel)^2)) — including the reference's log10/exp base mix
    (speech_feat.py:35-58);
  * volume: int16-normalized frames of 256 samples, hop 128,
    median-centered absolute sum (calVolume, speech_feat.py:78-89);
  * pitch: pyworld dio+stonemask is a C++ dependency; this module provides a
    normalized-autocorrelation pitch tracker as the documented substitute
    (prosody features are staged into the database but unused by the shipped
    scoring — SURVEY §2.9).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np


def hann_window(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def stft_mag(wav: np.ndarray, n_fft: int = 1024, hop: int = 256,
             win_length: int = 1024) -> np.ndarray:
    """Magnitude STFT matching librosa(center=True, pad_mode='constant'):
    zero-pad n_fft//2 both sides, hann window, frames at hop. -> (bins, T)."""
    pad = n_fft // 2
    x = np.pad(wav.astype(np.float64), (pad, pad))
    n_frames = 1 + (len(x) - n_fft) // hop
    win = hann_window(win_length)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx] * win
    return np.abs(np.fft.rfft(frames, n_fft, axis=1)).T


def hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    mel = np.where(log_region,
                   15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                   / (np.log(6.4) / 27.0), mel)
    return mel


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3)
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0)
                                             * (m - 15.0)), f)
    return f


def mel_bank_slaney(sr: int, n_fft: int, n_mels: int, fmin: float,
                    fmax: float) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney') semantics."""
    fftfreqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mels = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax),
                       n_mels + 2)
    mel_f = mel_to_hz_slaney(mels)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights


def get_energy(wav: np.ndarray, sr: int = 16000, hop: int = 256,
               n_fft: int = 1024, n_mels: int = 80, fmin: float = 80,
               fmax: float = 7600, eps: float = 1e-10) -> np.ndarray:
    """FastSpeech2-style energy (speech_feat.get_energy:53-58)."""
    spc = stft_mag(wav, n_fft=n_fft, hop=hop)            # (bins, T)
    mel = mel_bank_slaney(sr, n_fft, n_mels, fmin, fmax) @ spc
    mel = np.log10(np.maximum(eps, mel)).T               # (T, n_mels)
    return np.sqrt((np.exp(mel) ** 2).sum(-1))


def cal_volume(wav_int16: np.ndarray, frame_size: int = 256,
               overlap: int = 128) -> np.ndarray:
    """calVolume port (speech_feat.py:78-89): (n_frames,) abs-sum volume."""
    data = wav_int16.astype(np.float64)
    # eps guard: a silent (all-zero) input must not become 0/0 = NaN and
    # poison the stored volume feature
    data = data / max(np.abs(data).max(), 1e-12)
    step = frame_size - overlap
    n = int(math.ceil(len(data) / step))
    out = np.zeros(n)
    for i in range(n):
        frame = data[i * step: min(i * step + frame_size, len(data))]
        frame = frame - np.median(frame)
        out[i] = np.sum(np.abs(frame))
    return out


def get_pitch(wav: np.ndarray, sr: int = 16000, hop: int = 256,
              fmin: float = 71.0, fmax: float = 800.0, log: bool = True,
              norm: bool = True, eps: float = 1e-5) -> np.ndarray:
    """Autocorrelation pitch tracker (substitute for pyworld dio+stonemask;
    same output contract: per-hop f0, log'd and normalized like
    speech_feat.get_pitch:25-33)."""
    frame = int(sr * 0.04)
    lag_min = int(sr / fmax)
    lag_max = min(int(sr / fmin), frame - 1)
    n = max(1, 1 + (len(wav) - frame) // hop) + 1
    f0 = np.zeros(n)
    x = wav.astype(np.float64)
    for i in range(n):
        seg = x[i * hop: i * hop + frame]
        if len(seg) < frame:
            seg = np.pad(seg, (0, frame - len(seg)))
        seg = seg - seg.mean()
        ac = np.correlate(seg, seg, mode="full")[frame - 1:]
        if ac[0] <= 0:
            continue
        ac = ac / ac[0]
        window = ac[lag_min:lag_max]
        peak = np.argmax(window) + lag_min
        if ac[peak] > 0.3:  # voicing threshold
            f0[i] = sr / peak
    if log:
        f0 = np.log(np.maximum(eps, f0))
    if norm:
        std = f0.std()
        f0 = (f0 - f0.mean()) / (std if std > 0 else 1.0)
    return f0


def interp_to_fps(feature: np.ndarray, n_frames: int) -> np.ndarray:
    """Linear-resample a per-hop feature to n_frames motion frames
    (the 60 fps interpolation step of make_beat_dataset step 2)."""
    if len(feature) == n_frames:
        return feature.copy()
    src = np.linspace(0.0, 1.0, len(feature))
    dst = np.linspace(0.0, 1.0, n_frames)
    return np.interp(dst, src, feature)
