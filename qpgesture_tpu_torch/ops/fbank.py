"""Kaldi filter-bank features on the device: w2v-BERT 2.0's front end.

The features of ``transformers``' ``SeamlessM4TFeatureExtractor`` (its
``audio_utils.spectrogram`` with Kaldi's settings), batched over windows,
each window its own utterance (QPGesture encodes every 4 s window alone):

  1. samples at int16 scale (x 32768), 400-sample frames at hop 160, no
     centring (398 frames for a 64 000-sample window);
  2. per frame: its mean subtracted, pre-emphasis 0.97 inside the frame
     (x[n] -= 0.97 x[n-1], x[0] *= 0.03), the Povey window (Hann^0.85,
     symmetric, 400 taps);
  3. a 512-point real FFT, the power spectrum (257 bins);
  4. 80 Kaldi-mel triangles from 20 Hz to 8 kHz, built in mel space and
     unnormalised; max(., 1.1920929e-7) and the natural log;
  5. each mel bin normalised over the window's frames:
     (x - mean) / sqrt(var_unbiased + 1e-7);
  6. frame pairs stacked: (frames // 2, 160).

Float32 throughout, the mel product with TF32 off (the package's setting).
The extractor computes in float64 and rounds its output to float32; the
two agree within tests/test_torch_w2v_bert.py's tolerance. The window and
the mel bank are built once per device and kept.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


SAMPLE_RATE = 16000
FRAME_LENGTH = 400
HOP_LENGTH = 160
FFT_LENGTH = 512
MEL_BINS = 80
MIN_FREQUENCY = 20.0
PREEMPHASIS = 0.97
WINDOW_POWER = 0.85          # Povey: Hann ** 0.85
MEL_FLOOR = 1.192092955078125e-07
NORM_EPS = 1e-7
STRIDE = 2                   # frames stacked into one feature row
FEATURE_DIM = MEL_BINS * STRIDE


def _kaldi_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_bank() -> np.ndarray:
    """(FFT_LENGTH // 2 + 1, MEL_BINS) float64 triangles, laid out in
    Kaldi-mel space between MIN_FREQUENCY and the Nyquist frequency."""
    n_bins = FFT_LENGTH // 2 + 1
    edges = np.linspace(_kaldi_mel(MIN_FREQUENCY),
                        _kaldi_mel(SAMPLE_RATE // 2), MEL_BINS + 2)
    bins = _kaldi_mel(SAMPLE_RATE / FFT_LENGTH * np.arange(n_bins))
    rise = (bins[:, None] - edges[None, :-2]) / np.diff(edges)[None, :-1]
    fall = (edges[None, 2:] - bins[:, None]) / np.diff(edges)[None, 1:]
    return np.maximum(0.0, np.minimum(rise, fall))


def povey_window() -> np.ndarray:
    """The symmetric FRAME_LENGTH-tap Hann window to the power 0.85."""
    return np.power(np.hanning(FRAME_LENGTH), WINDOW_POWER)


_CONSTS: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _constants(device: torch.device):
    if device not in _CONSTS:
        _CONSTS[device] = tuple(
            torch.as_tensor(x, dtype=torch.float32, device=device)
            for x in (povey_window(), mel_bank()))
    return _CONSTS[device]


def n_frames(n_samples: int) -> int:
    """Stacked feature rows of one window of n_samples."""
    return (1 + (n_samples - FRAME_LENGTH) // HOP_LENGTH) // STRIDE


def fbank(wav: torch.Tensor) -> torch.Tensor:
    """(B, n_samples) float wav at +-1 -> (B, n_frames, FEATURE_DIM)
    float32 normalised, stacked log-mel features, on wav's device."""
    window, bank = _constants(wav.device)
    x = wav.float() * 32768.0
    frames = x.unfold(-1, FRAME_LENGTH, HOP_LENGTH)            # (B, F, 400)
    frames = frames - frames.mean(-1, keepdim=True)
    a = PREEMPHASIS
    frames = torch.cat((frames[..., :1] * (1.0 - a),
                        frames[..., 1:] - a * frames[..., :-1]), -1)
    spec = torch.fft.rfft(frames * window, n=FFT_LENGTH)
    power = spec.real.square() + spec.imag.square()           # (B, F, 257)
    logmel = torch.log(torch.clamp_min(power @ bank, MEL_FLOOR))
    mean = logmel.mean(1, keepdim=True)
    var = logmel.var(1, keepdim=True, unbiased=True)
    feats = (logmel - mean) / torch.sqrt(var + NORM_EPS)
    B, F, M = feats.shape
    keep = F - F % STRIDE
    return feats[:, :keep].reshape(B, keep // STRIDE, M * STRIDE)
