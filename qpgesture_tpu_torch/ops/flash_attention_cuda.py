"""CUDA kernel for attention with WavLM's gated relative position bias.

Replaces the TPU kernel ``qpgesture_tpu/ops/flash_attention.py ::
gated_flash_attention``. The kernel source is ``csrc/flash_attention.cu``
(its header says what bounds it on an H100 and what the design does about
it). It is compiled with ``nvcc`` for ``sm_90a`` on first use
(``ops/cuda_build.py``) and bound with ctypes.

``gated_flash_attention`` is the wrapper: for CPU tensors it runs the plain
PyTorch version (``gated_attention_plain``); for CUDA tensors it launches
the kernel or raises. ``launches`` counts kernel launches.

Unlike the TPU wrapper, this one pads nothing: the kernel masks the ragged
T edge itself, and q, k, v may be strided (B, H, T, hd) views with a
contiguous hd axis, such as the (B, T, H, hd) projections of WavLM seen
through a transpose. The output is allocated in the (B, T, H, hd) layout
and returned as its (B, H, T, hd) view, so that the caller's transpose
back is free.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .flash_attention import (check_inputs, gated_attention_plain,
                              resolve_kernel_dtype)

SOURCE = "flash_attention.cu"
# Head dims the kernel is instantiated for (template<int HD>): 64 is
# WavLM-Large's and Base's; 16 and 32 are the small test models'.
HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

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
        fn = lib.qpg_gated_flash_attention_cuda
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bht_strides(x: torch.Tensor):
    return x.stride(0), x.stride(1), x.stride(2)


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

    def prep(x: torch.Tensor) -> torch.Tensor:
        x = x.to(kd)
        return x if x.stride(-1) == 1 else x.contiguous()

    q, k, v = prep(q), prep(k), prep(v)
    bias = bias.to(kd).contiguous()
    if gate is not None:
        gate = gate.to(kd).contiguous()
    out = torch.empty((B, T, H, hd), dtype=torch.float32,
                      device=q.device).transpose(1, 2)
    if B == 0 or T == 0:
        return out
    # q is scaled in the kernel dtype, as the TPU wrapper does
    scale = float(torch.tensor(sm_scale, dtype=kd))
    strides = (ctypes.c_longlong * 12)(*_bht_strides(q), *_bht_strides(k),
                                       *_bht_strides(v), *_bht_strides(out))
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.qpg_gated_flash_attention_cuda(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if gate is None else gate.data_ptr(), out.data_ptr(),
            strides, B, H, T, hd, _DTYPE_CODES[kd], scale, stream)
    if err != 0:
        raise RuntimeError(f"gated flash attention kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out
