"""Kernel K7: the per-code candidate reduction of the engine's tables.

For a (Q, N) distance matrix and the (N,) code of each database position,
each query row's least distance per code, its first position in scan order
(the reference's strict-< update, GestureKNN.py:686-689) and whether the
code occurs at all.

Replaces no TPU kernel: the JAX package reduces with two
``jax.ops.segment_min`` passes (``qpgesture_tpu/match/engine.py:89-109``).
The plain version below does the same with two ``scatter_reduce`` passes, a
gather and a ``where`` over the (Q, N) matrix; on the card that took 133 ms
of a 768-query batch against 425 984 positions. K7 makes one pass of 64-bit
(distance, position) keys instead (the kernel source, ``csrc/segmin.cu``,
says how), compiled with ``nvcc`` for ``sm_90a`` on first use
(``ops/cuda_build.py``) and bound with ctypes.

``segment_min_argmin`` is the wrapper: for CPU tensors it runs the plain
version (``segment_min_argmin_plain``); for CUDA tensors it launches the
kernel pair or raises. It takes float32 distances and K1's int32 edit
distances as they are (an int32 matrix is reduced as its float32 copy
would be: exact for distances below 2**24). ``launches`` counts kernel
launches, two a call.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build

SOURCE = "segmin.cu"
DTYPES = (torch.float32, torch.int32)
# The plan: a block holds ROWS query rows (the kernel's R) and reads at
# least MIN_COLS columns of them (N permitting), so that the keys it writes
# out stay small beside what it read; MAX_K bounds the codebook, whose
# ROWS x k keys a block holds in shared memory.
ROWS = 8
MIN_COLS = 2048
MAX_K = 2048

launches = 0
_lib = None
_per_sm = {}
_sms = {}


def build() -> str:
    """Compile the kernel library unless this source was built already;
    returns the path of the shared library."""
    return cuda_build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.qpg_segmin_cuda.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
            + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
        lib.qpg_segmin_cuda.restype = ctypes.c_int
        lib.qpg_segmin_blocks_per_sm.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.qpg_segmin_blocks_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_inputs(dist: torch.Tensor, seg: torch.Tensor, k: int) -> None:
    """Raise on shapes, types, layouts or devices the function does not
    take."""
    if dist.dim() != 2 or seg.dim() != 1 or seg.shape[0] != dist.shape[1]:
        raise ValueError(f"dist must be (Q, N) and seg (N,), got "
                         f"{tuple(dist.shape)} and {tuple(seg.shape)}")
    if dist.dtype not in DTYPES:
        raise TypeError(f"dist must be float32 or int32, got {dist.dtype}")
    if seg.dtype != torch.int64:
        raise TypeError(f"seg must be int64, got {seg.dtype}")
    if not (dist.is_contiguous() and seg.is_contiguous()):
        raise ValueError("dist and seg must be contiguous")
    if dist.device != seg.device:
        raise ValueError(f"inputs on different devices: {dist.device}, "
                         f"{seg.device}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")


def segment_min_argmin_plain(dist: torch.Tensor, seg: torch.Tensor, k: int,
                             unmatched: float
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The reduction in plain PyTorch: the least distance of each code by
    ``scatter_reduce("amin")``, its first position by a second one over the
    positions that hold it. An int32 matrix is reduced as float32."""
    check_inputs(dist, seg, k)
    dist = dist.to(torch.float32)
    Q, N = dist.shape
    idx = seg.expand(Q, N)
    mins = torch.full((Q, k), float("inf"), dtype=dist.dtype,
                      device=dist.device).scatter_reduce(
        1, idx, dist, "amin", include_self=False)
    hit = dist == mins.gather(1, idx)
    pos = torch.where(hit, torch.arange(N, device=dist.device).expand(Q, N),
                      N)
    args = torch.full((Q, k), N, dtype=torch.int64,
                      device=dist.device).scatter_reduce(
        1, idx, pos, "amin", include_self=False)
    matched = torch.isfinite(mins)
    mins = torch.where(matched, mins, torch.full_like(mins, unmatched))
    args = torch.where(args >= N, 0, args)
    return mins, args, matched


def plan(Q: int, N: int, sms: int, per_sm: int) -> Tuple[int, int]:
    """(splits, chunk) of the N columns: the ceil(Q / ROWS) row groups
    times the splits fill at most one wave of the card's resident blocks
    (sms x per_sm), each block reads at least MIN_COLS columns (N
    permitting), and chunk is a multiple of 4."""
    groups = -(-Q // ROWS)
    splits = max(1, min(sms * per_sm // groups, N // MIN_COLS))
    chunk = -(-N // splits)
    chunk += -chunk % 4
    return -(-N // chunk), chunk


def _resident(device: torch.device, k: int, is_int: int) -> Tuple[int, int]:
    """(SMs, resident pass blocks an SM holds) for this card and k."""
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    key = (device, k, is_int)
    if key not in _per_sm:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _load().qpg_segmin_blocks_per_sm(k, is_int,
                                                   ctypes.byref(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"segmin kernel cannot be resident at k={k} "
                               f"(cudaError {err})")
        _per_sm[key] = out.value
    return _sms[device], _per_sm[key]


def segment_min_argmin(dist: torch.Tensor, seg: torch.Tensor, k: int,
                       unmatched: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dist (Q, N) float32 or int32 and seg (N,) int64 codes, both
    contiguous -> (mins (Q, k) float32, ``unmatched`` where a code never
    occurs or its least distance is not finite; args (Q, k) int64, the first
    position of the least distance, 0 where the code never occurs; matched
    (Q, k) bool, whether the least distance is finite)."""
    global launches
    check_inputs(dist, seg, k)
    if dist.device.type == "cpu":
        return segment_min_argmin_plain(dist, seg, k, unmatched)
    if dist.device.type != "cuda":
        raise ValueError(f"unsupported device {dist.device}")
    Q, N = dist.shape
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's {MAX_K} codes")
    if N >= 2 ** 31:
        raise ValueError(f"N={N} exceeds the kernel's 32-bit positions")
    if Q == 0 or N == 0:
        return (torch.full((Q, k), unmatched, device=dist.device),
                torch.zeros((Q, k), dtype=torch.int64, device=dist.device),
                torch.zeros((Q, k), dtype=torch.bool, device=dist.device))
    mins = torch.empty((Q, k), dtype=torch.float32, device=dist.device)
    args = torch.empty((Q, k), dtype=torch.int64, device=dist.device)
    matched = torch.empty((Q, k), dtype=torch.bool, device=dist.device)
    is_int = int(dist.dtype == torch.int32)
    lib = _load()
    sms, per_sm = _resident(dist.device, k, is_int)
    splits, chunk = plan(Q, N, sms, per_sm)
    partials = torch.empty((Q, splits, k), dtype=torch.int64,
                           device=dist.device)
    with torch.cuda.device(dist.device):
        err = lib.qpg_segmin_cuda(
            dist.data_ptr(), is_int, seg.data_ptr(), partials.data_ptr(),
            mins.data_ptr(), args.data_ptr(), matched.data_ptr(), Q, N, k,
            splits, chunk, float(unmatched),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segmin kernel launch failed (cudaError {err})")
    launches += 2
    return mins, args, matched
