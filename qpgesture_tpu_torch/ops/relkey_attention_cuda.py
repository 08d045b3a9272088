"""Kernel K4: attention with a relative-key term, w2v-BERT 2.0's attention.

    s_ij = q_i . k_j + q_i . E[clamp(j - i, -left, right) + left]
    out_i = sum_j softmax_j(s_ij * sm_scale) v_j

with q, k, v (B, H, T, hd) and one (left + right + 1, hd) table E of
distance embeddings shared by every head (``transformers``'
``Wav2Vec2BertSelfAttention`` with ``position_embeddings_type ==
"relative_key"``; the distance is key minus query). The term depends on
the query, so it is a (B, H, T, T) array and cannot be K2's bias, which is
shared across the batch.

Replaces no TPU kernel: the JAX package has no w2v-BERT. The kernel source
is ``csrc/relkey_attention.cu`` (its header says what bounds it on an H100
and what the design does about it), float32 on the CUDA cores, compiled
with ``nvcc`` for ``sm_90a`` on first use (``ops/cuda_build.py``) and bound
with ctypes.

``relkey_attention`` is the wrapper: for CPU tensors it runs the plain
version (``relkey_attention_plain``); for CUDA tensors it launches the
kernel or raises. ``launches`` counts kernel launches. Like K2's wrapper it
takes strided (B, H, T, hd) views with a contiguous hd axis (the
(B, T, H, hd) projections seen through a transpose) and returns its output
as the (B, H, T, hd) view of a (B, T, H, hd) tensor.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

SOURCE = "relkey_attention.cu"
HEAD_DIMS = (16, 64)          # template<int HD>: w2v-BERT's, the tests' small
MAX_DISTANCES = 128           # rows of E the kernel's shared memory holds
_ALIGN = 16                   # bytes: the kernel's cp.async granule

launches = 0
_fn = None


def build() -> str:
    """Compile the kernel library unless this source was built already;
    returns the path of the shared library."""
    return cuda_build.build(SOURCE)


def _load():
    global _fn
    if _fn is None:
        fn = ctypes.CDLL(build()).qpg_relkey_attention_cuda
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 emb: torch.Tensor, left: int, right: int) -> None:
    """Raise on shapes, types or devices the function does not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if left < 0 or right < 0:
        raise ValueError(f"left {left} and right {right} must be >= 0")
    n_rel = left + right + 1
    if tuple(emb.shape) != (n_rel, q.shape[-1]):
        raise ValueError(f"emb must be (left + right + 1, hd) = "
                         f"{(n_rel, q.shape[-1])}, got {tuple(emb.shape)}")
    if any(x.dtype != torch.float32 for x in (q, k, v, emb)):
        raise TypeError("q, k, v and emb must be float32")
    devices = {x.device for x in (q, k, v, emb)}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{sorted(map(str, devices))}")


def distances(T: int, left: int, right: int, device) -> torch.Tensor:
    """(T, T) row of E for query i and key j: clamp(j - i) + left."""
    pos = torch.arange(T, device=device)
    return torch.clamp(pos[None, :] - pos[:, None], -left, right) + left


def relkey_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           emb: torch.Tensor, *, left: int, right: int,
                           sm_scale: float) -> torch.Tensor:
    """The materialised version, rounding where the kernel rounds: q scaled
    first, s = q k^T + (q E^T)[dist] in float32, the softmax over s.
    Returns (B, H, T, hd) float32."""
    check_inputs(q, k, v, emb, left, right)
    T = q.shape[2]
    q = q * sm_scale
    rel = torch.matmul(q, emb.t())                    # (B, H, T, n_rel)
    idx = distances(T, left, right, q.device)
    s = torch.matmul(q, k.transpose(-1, -2)) + torch.gather(
        rel, 3, idx.expand(*rel.shape[:2], T, T))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def _aligned(x: torch.Tensor, n_strides: int) -> bool:
    per = _ALIGN // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % _ALIGN == 0
            and all(s % per == 0 for s in x.stride()[:n_strides]))


def relkey_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     emb: torch.Tensor, *, left: int, right: int,
                     sm_scale: float) -> torch.Tensor:
    """softmax((q k^T + q E[clamp(j - i, -left, right) + left]^T) *
    sm_scale) v for q, k, v (B, H, T, hd) float32 and emb (left + right +
    1, hd). Returns (B, H, T, hd) float32."""
    global launches
    check_inputs(q, k, v, emb, left, right)
    if q.device.type == "cpu":
        return relkey_attention_plain(q, k, v, emb, left=left, right=right,
                                      sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, T, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel instantiation "
                         f"(have {HEAD_DIMS})")
    if left + right + 1 > MAX_DISTANCES:
        raise ValueError(f"{left + right + 1} distances exceed the "
                         f"kernel's {MAX_DISTANCES}")
    if B >= 2 ** 16 or H >= 2 ** 16 or T >= 2 ** 31:
        raise ValueError(f"B={B}, H={H}, T={T} exceed the kernel's grid")
    q, k, v = (x if _aligned(x, 3) else x.contiguous() for x in (q, k, v))
    emb = emb.contiguous()
    if not all(_aligned(x, 3) for x in (q, k, v)) or \
            emb.data_ptr() % _ALIGN:
        raise ValueError("q, k, v rows and emb must start on 16-byte "
                         "boundaries")
    out = torch.empty((B, T, H, hd), dtype=torch.float32,
                      device=q.device).transpose(1, 2)
    if B == 0 or T == 0:
        return out
    fn = _load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), emb.data_ptr(),
            out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], B, H, T, hd, left, right,
            float(sm_scale))
    if q.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"relative-key attention kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out
