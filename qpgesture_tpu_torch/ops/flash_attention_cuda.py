"""CUDA kernel for attention with WavLM's gated relative position bias.

Replaces the TPU kernel ``qpgesture_tpu/ops/flash_attention.py ::
gated_flash_attention``. The kernel source is ``csrc/flash_attention.cu``
(its header says what bounds it on an H100 and what the design does about
it): float32 on the CUDA cores, bfloat16 on the tensor cores. It is
compiled with ``nvcc`` for ``sm_90a`` on first use (``ops/cuda_build.py``)
and bound with ctypes.

``gated_flash_attention`` is the wrapper: for CPU tensors it runs the plain
PyTorch version (``gated_attention_plain``); for CUDA tensors it launches
the kernel or raises. ``launches`` counts kernel launches.

Unlike the TPU wrapper, this one pads nothing: the kernel masks the ragged
T edge itself, and q, k, v may be strided (B, H, T, hd) views with a
contiguous hd axis, such as the (B, T, H, hd) projections of WavLM seen
through a transpose. The kernel copies rows with 16-byte asynchronous
copies, so every row must start on a 16-byte boundary: an input that does
not is copied into a fresh tensor, and the bias's row stride is rounded up
(``prepare_bias``; WavLM calls it once per forward, not once per layer).
The output is allocated in the (B, T, H, hd) layout and returned as its
(B, H, T, hd) view, so that the caller's transpose back is free.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build
from .flash_attention import (check_inputs, gated_attention_plain,
                              resolve_kernel_dtype)

SOURCE = "flash_attention.cu"
# Head dims the kernel is instantiated for (template<int HD>): 64 is
# WavLM-Large's and Base's; 16 and 32 are the small test models'.
HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16         # bytes: the kernel's cp.async granule

launches = 0
_fn = None
_scales: Dict[Tuple[float, torch.dtype], float] = {}


def build() -> str:
    """Compile the kernel library unless this source was built already;
    returns the path of the shared library."""
    return cuda_build.build(SOURCE)


def _load():
    global _fn
    if _fn is None:
        fn = ctypes.CDLL(build()).qpg_gated_flash_attention_cuda
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 14
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _rounded_scale(sm_scale: float, kd: torch.dtype) -> float:
    """sm_scale rounded to the kernel dtype, as the TPU wrapper scales q."""
    key = (sm_scale, kd)
    if key not in _scales:
        _scales[key] = float(torch.tensor(sm_scale, dtype=kd))
    return _scales[key]


def _aligned(x: torch.Tensor, n_strides: int) -> bool:
    """Last axis contiguous; base and the first n_strides strides on
    16-byte boundaries."""
    per = _ALIGN // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % _ALIGN == 0
            and all(s % per == 0 for s in x.stride()[:n_strides]))


def _prep(x: torch.Tensor, kd: torch.dtype) -> torch.Tensor:
    if x.dtype != kd:
        x = x.to(kd)
    if not _aligned(x, 3):
        x = torch.empty(x.shape, dtype=kd, device=x.device).copy_(x)
    return x


def prepare_bias(bias: torch.Tensor,
                 kernel_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The (H, T, T) bias in the kernel dtype and in the layout the kernel
    reads: a view whose rows start on 16-byte boundaries (row stride T
    rounded up, the padding zero). Returns `bias` itself when it is already
    so; CPU tensors are only cast."""
    kd = bias.dtype if kernel_dtype is None else kernel_dtype
    if bias.device.type != "cuda":
        return bias.to(kd)
    if bias.dtype == kd and _aligned(bias, 2):
        return bias
    H, T, _ = bias.shape
    per = _ALIGN // torch.empty((), dtype=kd).element_size()
    buf = torch.zeros((H, T, -(-T // per) * per), dtype=kd,
                      device=bias.device)
    buf[..., :T] = bias
    return buf[..., :T]


def gated_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor,
                          gate: Optional[torch.Tensor] = None, *,
                          sm_scale: float = 1.0,
                          kernel_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """softmax(q @ k^T * sm_scale + gate * bias) @ v.

    q, k, v : (B, H, T, hd)
    bias    : (H, T, T), shared across the batch
    gate    : (B, H, T) per-query bias gate, or None (plain additive bias)
    kernel_dtype : float32 or bfloat16, the type q, k, v, bias and gate are
        cast to (None keeps q's); the softmax statistics and the
        accumulator stay float32.
    Returns (B, H, T, hd) float32.
    """
    global launches
    check_inputs(q, k, v, bias, gate)
    if q.device.type == "cpu":
        return gated_attention_plain(q, k, v, bias, gate, sm_scale=sm_scale,
                                     kernel_dtype=kernel_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    kd = resolve_kernel_dtype(q, kernel_dtype)
    B, H, T, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel instantiation "
                         f"(have {HEAD_DIMS})")
    if B >= 2 ** 16 or H >= 2 ** 16:
        raise ValueError(f"B={B}, H={H} exceed the kernel's grid")

    q, k, v = _prep(q, kd), _prep(k, kd), _prep(v, kd)
    bias = prepare_bias(bias, kd)
    if gate is not None and (gate.dtype != kd or not gate.is_contiguous()):
        gate = gate.to(kd).contiguous()
    out = torch.empty((B, T, H, hd), dtype=torch.float32,
                      device=q.device).transpose(1, 2)
    if B == 0 or T == 0:
        return out
    fn = _load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if gate is None else gate.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], bias.stride(0), bias.stride(1),
            B, H, T, hd, _DTYPE_CODES[kd], _rounded_scale(sm_scale, kd))
    if q.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gated flash attention kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out
