"""ctypes binding of the repo's native host library (native/qpg_native.cpp).

Only the WORLD pitch tracker is bound here: the database builder's pitch
feature goes through it when the library builds, as the JAX package's does,
so both packages store the same bits. Built on demand with
``make -C native`` (g++); without a compiler the NumPy transcription in
``pipelines/pitch_world.py`` runs instead.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libqpg_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it neither builds nor exists. make
    decides by mtime whether to recompile, so a stale library never shadows
    an edited source."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        if not os.path.exists(_LIB_PATH):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.qpg_pitch_world.restype = ctypes.c_long
    lib.qpg_pitch_world.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_long]
    _lib = lib
    return _lib


def pitch_world_native(wav: np.ndarray, fs: int, frame_period: float,
                       f0_floor: float = 71.0, f0_ceil: float = 800.0,
                       channels_in_octave: float = 2.0,
                       allowed_range: float = 0.1) -> Optional[np.ndarray]:
    """Native WORLD DIO + StoneMask (qpg_pitch_world); None when the library
    is unavailable, so the caller falls back to the NumPy transcription."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(wav, np.float64)
    n_frames = int(1000.0 * len(x) / fs / frame_period) + 1
    out = np.zeros(n_frames, np.float64)
    got = lib.qpg_pitch_world(
        x.ctypes.data_as(ctypes.c_void_p), len(x), fs,
        ctypes.c_double(frame_period), ctypes.c_double(f0_floor),
        ctypes.c_double(f0_ceil), ctypes.c_double(channels_in_octave),
        ctypes.c_double(allowed_range),
        out.ctypes.data_as(ctypes.c_void_p), n_frames)
    if got < 0:
        return None
    return out[:got]
