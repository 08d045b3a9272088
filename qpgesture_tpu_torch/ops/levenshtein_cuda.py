"""CUDA kernel for the all-pairs edit-distance matrix (the wavvq phase 1).

Replaces the TPU kernel ``qpgesture_tpu/ops/pallas_kernels.py ::
levenshtein_matrix_pallas``. The kernel source is ``csrc/levenshtein.cu``
(its header says what bounds it on an H100 and what the design does about
it). It is compiled with ``nvcc`` for ``sm_90a`` on first use
(``ops/cuda_build.py``) and bound with ctypes.

``levenshtein_matrix`` is the wrapper: for CPU tensors it runs the plain
PyTorch version (``levenshtein_matrix_plain``); for CUDA tensors it launches
the kernel or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .levenshtein import levenshtein_matrix as levenshtein_matrix_plain

SOURCE = "levenshtein.cu"
# String lengths the kernel is instantiated for (template<int L>).
LENGTHS = (11,)

launches = 0
_lib = None


def build() -> str:
    """Compile the kernel library unless this source was built already;
    returns the path of the shared library."""
    return cuda_build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.qpg_levenshtein_matrix_cuda
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def levenshtein_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, L) x (N, L) int32 code strings -> (Q, N) int32 edit distances."""
    global launches
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"expected (Q, L) and (N, L) strings of one length, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"expected int32 strings, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"inputs on different devices: {a.device}, "
                         f"{b.device}")
    if a.device.type == "cpu":
        return levenshtein_matrix_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    Q, L = a.shape
    N = b.shape[0]
    if L not in LENGTHS:
        raise ValueError(f"string length {L} has no kernel instantiation "
                         f"(have {LENGTHS})")
    if max(Q, N) >= 2 ** 31:
        raise ValueError(f"Q={Q}, N={N} exceed the kernel's int32 extents")
    out = torch.empty((Q, N), dtype=torch.int32, device=a.device)
    if Q == 0 or N == 0:
        return out
    lib = _load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.qpg_levenshtein_matrix_cuda(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), Q, N, L, stream)
    if err != 0:
        raise RuntimeError(f"Levenshtein kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out
