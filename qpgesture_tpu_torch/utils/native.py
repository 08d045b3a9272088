"""ctypes binding of the repo's native host library (native/qpg_native.cpp).

Two parts are bound here, each with a pure-Python fallback:
  * the WORLD pitch tracker: the database builder's pitch feature goes
    through it when the library builds, as the JAX package's does, so both
    packages store the same bits (without a compiler the NumPy
    transcription in ``pipelines/pitch_world.py`` runs instead);
  * the append-only record store (``RecordStore``), the trainers' raw-clip
    cache: the native writer/reader and the Python fallback share one
    on-disk format, so a store written by either package (or either path)
    reads back through the other.
Built on demand with ``make -C native`` (g++).
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
    lib.qpg_store_create.restype = ctypes.c_void_p
    lib.qpg_store_create.argtypes = [ctypes.c_char_p]
    lib.qpg_store_append.restype = ctypes.c_int64
    lib.qpg_store_append.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64]
    lib.qpg_store_finalize.restype = ctypes.c_int64
    lib.qpg_store_finalize.argtypes = [ctypes.c_void_p]
    lib.qpg_store_open.restype = ctypes.c_void_p
    lib.qpg_store_open.argtypes = [ctypes.c_char_p]
    lib.qpg_store_count.restype = ctypes.c_int64
    lib.qpg_store_count.argtypes = [ctypes.c_void_p]
    lib.qpg_store_record_len.restype = ctypes.c_int64
    lib.qpg_store_record_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.qpg_store_read.restype = ctypes.c_int64
    lib.qpg_store_read.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_int64]
    lib.qpg_store_close.restype = None
    lib.qpg_store_close.argtypes = [ctypes.c_void_p]
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


# -- record store -------------------------------------------------------------
# Layout (qpg_native.cpp): [magic u64][records...][u64 offsets][u64 lengths]
# [n_records u64][index_offset u64], all little-endian.
_STORE_MAGIC = 0x51504753544F5245     # "QPGSTORE"


class RecordStore:
    """Append-only mmap record store, the trainers' raw-clip cache (the
    reference's LMDB cache). ``create`` returns a writer, ``open`` a reader;
    both go through the native library when it builds and through the
    byte-compatible Python classes below otherwise."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib

    @classmethod
    def create(cls, path: str):
        lib = get_lib()
        if lib is None:
            return _PyStoreWriter(path)
        h = lib.qpg_store_create(path.encode())
        if not h:
            raise OSError(f"cannot create store {path}")
        return _NativeStoreWriter(h, lib)

    @classmethod
    def open(cls, path: str):
        lib = get_lib()
        if lib is None:
            return _PyStore(path)
        h = lib.qpg_store_open(path.encode())
        if not h:
            raise OSError(f"cannot open store {path}")
        return cls(h, lib)

    def __len__(self) -> int:
        return int(self._lib.qpg_store_count(self._h))

    def __getitem__(self, i: int) -> bytes:
        ln = self._lib.qpg_store_record_len(self._h, i)
        if ln < 0:
            raise IndexError(i)
        buf = ctypes.create_string_buffer(ln)
        got = self._lib.qpg_store_read(self._h, i, buf, ln)
        if got != ln:
            raise OSError(f"record {i}: read {got} of {ln} bytes")
        return buf.raw

    def close(self) -> None:
        if self._h:
            self._lib.qpg_store_close(self._h)
            self._h = None


class _NativeStoreWriter:
    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib

    def append(self, data: bytes) -> int:
        got = int(self._lib.qpg_store_append(self._h, data, len(data)))
        if got < 0:
            raise OSError("record store write failed")
        return got

    def finalize(self) -> int:
        n = int(self._lib.qpg_store_finalize(self._h))
        self._h = None
        return n


class _PyStoreWriter:
    """Pure-Python writer with the native on-disk format."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(_STORE_MAGIC.to_bytes(8, "little"))
        self._pos = 8
        self._offsets: list = []
        self._lengths: list = []

    def append(self, data: bytes) -> int:
        self._offsets.append(self._pos)
        self._lengths.append(len(data))
        self._f.write(data)
        self._pos += len(data)
        return len(self._offsets) - 1

    def finalize(self) -> int:
        with self._f:
            for v in self._offsets + self._lengths:
                self._f.write(v.to_bytes(8, "little"))
            self._f.write(len(self._offsets).to_bytes(8, "little"))
            self._f.write(self._pos.to_bytes(8, "little"))
        return len(self._offsets)


class _PyStore:
    """Pure-Python reader; validates the tail index as qpg_store_open does,
    so a truncated or corrupt store fails to open here too."""

    def __init__(self, path: str):
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        size = self._mm.shape[0]
        if size < 32:
            raise OSError(f"store too small: {path}")
        if int.from_bytes(self._mm[:8].tobytes(), "little") != _STORE_MAGIC:
            raise OSError(f"bad magic in store: {path}")
        self._n = int.from_bytes(self._mm[size - 16:size - 8].tobytes(),
                                 "little")
        index_off = int.from_bytes(self._mm[size - 8:].tobytes(), "little")
        if (index_off < 8 or index_off > size
                or self._n > (size - index_off) // 16
                or index_off + 16 * self._n + 16 != size):
            raise OSError(f"corrupt store index: {path}")
        arr = np.frombuffer(
            self._mm[index_off:index_off + 16 * self._n].tobytes(), "<u8")
        self._offsets, self._lengths = arr[:self._n], arr[self._n:]
        if np.any(self._offsets + self._lengths > index_off):
            raise OSError(f"corrupt store records: {path}")

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> bytes:
        if not 0 <= i < self._n:
            raise IndexError(i)
        off, ln = int(self._offsets[i]), int(self._lengths[i])
        return self._mm[off:off + ln].tobytes()

    def close(self) -> None:
        del self._mm
