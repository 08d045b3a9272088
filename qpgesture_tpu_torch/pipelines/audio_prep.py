"""Host-side audio preparation: read, resample and loudness-normalise wavs.

The port of the pure-Python branches of
``qpgesture_tpu/pipelines/audio_prep.py``: scipy polyphase resampling and
an RMS loudness normalisation stand in for the reference's ffmpeg and sox
calls (codebook/Speech2GestureMatching/normalize_audio.py:5-13,
process/make_beat_dataset.py:167), so the port needs no external binary.
``load_wav_16k`` is the one-stop helper of the ``generate`` command.
"""
from __future__ import annotations

import os
import tempfile
import wave
from math import gcd
from typing import Tuple

import numpy as np


def _read_wav_scipy(path: str) -> Tuple[np.ndarray, int]:
    """Reader for formats the stdlib wave module rejects (IEEE-float wavs,
    WAVE_FORMAT_EXTENSIBLE)."""
    from scipy.io import wavfile
    sr, x = wavfile.read(path)
    x = np.asarray(x)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32768.0
    elif x.dtype == np.int32:
        x = x.astype(np.float32) / 2147483648.0
    elif x.dtype == np.uint8:
        x = (x.astype(np.float32) - 128.0) / 128.0
    else:
        x = x.astype(np.float32)
    if x.ndim > 1:
        x = x.mean(axis=1)
    return x, int(sr)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a wav into float32 [-1, 1] mono. Returns (wav, sr). Handles
    8/16/24/32-bit PCM via the stdlib and IEEE-float via scipy."""
    try:
        with wave.open(path, "rb") as f:
            sr = f.getframerate()
            n_ch = f.getnchannels()
            width = f.getsampwidth()
            raw = f.readframes(f.getnframes())
    except wave.Error:
        return _read_wav_scipy(path)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.uint32)
        u = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        signed = u.astype(np.int32) - ((u >> 23) & 1).astype(np.int32) * (1 << 24)
        x = signed.astype(np.float32) / 8388608.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """Write float32 [-1, 1] mono as PCM16 (the reference's sox
    '-b 16 -e signed-integer' target format, make_beat_dataset.py:167)."""
    pcm = np.clip(np.asarray(wav, np.float64) * 32768.0,
                  -32768, 32767).astype(np.int16)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def _resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    from scipy.signal import resample_poly
    g = gcd(sr_in, sr_out)
    return resample_poly(wav, sr_out // g, sr_in // g).astype(np.float32)


def resample_wav(in_path: str, out_path: str, sr: int = 16000) -> None:
    """Resample to `sr` mono PCM16 (polyphase)."""
    wav, sr_in = read_wav(in_path)
    write_wav(out_path, wav if sr_in == sr else _resample(wav, sr_in, sr),
              sr)


def normalize_wav(in_path: str, out_path: str, sr: int = 16000,
                  target_rms_db: float = -23.0) -> None:
    """Loudness-normalise to 16 kHz mono PCM16: RMS to `target_rms_db`
    dBFS (-23 is close to the EBU R128 integrated-loudness target of the
    reference's ffmpeg-normalize for speech)."""
    wav, sr_in = read_wav(in_path)
    if sr_in != sr:
        wav = _resample(wav, sr_in, sr)
    rms = float(np.sqrt(np.mean(np.square(wav)) + 1e-12))
    gain = 10.0 ** (target_rms_db / 20.0) / max(rms, 1e-8)
    write_wav(out_path, np.clip(wav * gain, -1.0, 1.0), sr)


def ensure_16k_wav(path: str, workdir: str) -> str:
    """Return a path to a 16 kHz mono PCM16 version of `path`, converting
    into workdir when needed."""
    try:
        with wave.open(path, "rb") as f:
            ok = (f.getframerate() == 16000 and f.getnchannels() == 1
                  and f.getsampwidth() == 2)
    except wave.Error:
        ok = False  # e.g. IEEE-float wav: convert below
    if ok:
        return path
    os.makedirs(workdir, exist_ok=True)
    out = os.path.join(
        workdir, os.path.splitext(os.path.basename(path))[0] + "_16k.wav")
    resample_wav(path, out, 16000)
    return out


def load_wav_16k(path: str) -> np.ndarray:
    """Read any supported wav as 16 kHz float32 mono, converting through a
    temporary directory when needed."""
    with tempfile.TemporaryDirectory() as td:
        wav, sr = read_wav(ensure_16k_wav(path, td))
    if sr != 16000:
        raise ValueError(f"{path}: expected 16 kHz after conversion, "
                         f"got {sr} Hz")
    return wav.astype(np.float32)
