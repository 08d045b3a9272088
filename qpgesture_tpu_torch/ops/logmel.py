"""Whisper's log-mel spectrogram on the device: Whisper-large-v3's front end.

The features of ``transformers``' ``WhisperFeatureExtractor`` (its torch
path), batched over utterances, each utterance its own 30 s input:

  1. the audio (+-1 scale) zero-padded on the right to 480 000 samples;
  2. a periodic Hann window of 400 taps, hop 160, centred frames with
     reflect padding (``torch.stft(center=True)``): 3001 frames, the last
     dropped, 3000 kept;
  3. the power spectrum (201 bins), 128 Slaney mel triangles from 0 to
     8000 Hz with Slaney's area normalisation;
  4. ``log10(max(x, 1e-10))``, then ``max(x, max over the utterance - 8)``,
     then ``(x + 4) / 4``.

Float32 throughout, the mel product with TF32 off (the package's setting),
as the extractor computes it. The mel bank is built in numpy (float64) at
import; the window and the bank are kept per device. One call does every
utterance of a batch at once and never waits for the card.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30
N_SAMPLES = CHUNK_SECONDS * SAMPLE_RATE        # 480 000
N_FRAMES = N_SAMPLES // HOP_LENGTH             # 3000
MEL_BINS = 128                                 # large-v3's num_mel_bins
MAX_HZ = 8000.0
LOG_FLOOR = 1e-10
DYNAMIC_RANGE = 8.0                            # log10 units kept below the max


def _hz_to_mel(f):
    """Slaney's mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0,
                    15.0 + np.log(np.maximum(f, 1e-12) / 1000.0)
                    * 27.0 / np.log(6.4),
                    3.0 * f / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0,
                    1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    200.0 * m / 3.0)


def mel_bank(n_mels: int = MEL_BINS) -> np.ndarray:
    """(N_FFT // 2 + 1, n_mels) float64 Slaney triangles between 0 Hz and
    MAX_HZ, each scaled by 2 / its width in Hz."""
    edges = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(MAX_HZ),
                                   n_mels + 2))
    bins = np.linspace(0.0, SAMPLE_RATE // 2, N_FFT // 2 + 1)
    width = np.diff(edges)
    rise = (bins[:, None] - edges[None, :-2]) / width[None, :-1]
    fall = (edges[None, 2:] - bins[:, None]) / width[None, 1:]
    tri = np.maximum(0.0, np.minimum(rise, fall))
    return tri * (2.0 / (edges[2:] - edges[:-2]))[None, :]


_BANKS: Dict[int, np.ndarray] = {MEL_BINS: mel_bank(MEL_BINS)}
_CONSTS: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _constants(device: torch.device, n_mels: int):
    key = (device, n_mels)
    if key not in _CONSTS:
        if n_mels not in _BANKS:
            _BANKS[n_mels] = mel_bank(n_mels)
        _CONSTS[key] = (
            torch.hann_window(N_FFT, periodic=True, dtype=torch.float32,
                              device=device),
            torch.as_tensor(_BANKS[n_mels].T, dtype=torch.float32,
                            device=device).contiguous())
    return _CONSTS[key]


def logmel(audio: torch.Tensor, n_mels: int = MEL_BINS) -> torch.Tensor:
    """(U, n) float audio at +-1, n <= N_SAMPLES -> (U, n_mels, N_FRAMES)
    float32 log-mel features of U utterances, each padded to 30 s and
    clamped to its own maximum less 8, on audio's device."""
    U, n = audio.shape
    if n > N_SAMPLES:
        raise ValueError(f"{n} samples is {n / SAMPLE_RATE:g} s, past "
                         f"Whisper's {CHUNK_SECONDS} s input")
    window, bank = _constants(audio.device, n_mels)
    x = F.pad(audio.float(), (0, N_SAMPLES - n))
    spec = torch.stft(x, N_FFT, HOP_LENGTH, window=window, center=True,
                      pad_mode="reflect", return_complex=True)[..., :-1]
    power = spec.real.square() + spec.imag.square()        # (U, 201, 3000)
    log = torch.clamp_min(bank @ power, LOG_FLOOR).log10()
    top = log.amax(dim=(1, 2), keepdim=True)
    return (torch.maximum(log, top - DYNAMIC_RANGE) + 4.0) / 4.0
