"""Attention with WavLM's gated relative position bias: the plain version.

    softmax(q @ k^T * sm_scale + gate * bias) @ v

This is the plain PyTorch counterpart of the TPU kernel
``qpgesture_tpu/ops/flash_attention.py :: gated_flash_attention`` and of
the CUDA kernel ``csrc/flash_attention.cu`` (wrapper:
``ops/flash_attention_cuda.py``). It materialises the (B, H, T, T) logits
and rounds where the kernels round:

  * q, k, v, bias and gate are cast to ``kernel_dtype`` (float32, or
    bfloat16), and q is scaled by ``sm_scale`` in that dtype;
  * the logits q @ k^T are summed in float32, and ``gate * bias`` is added
    in float32;
  * the softmax statistics are float32; the weights p are rounded to v's
    dtype before p @ v, which is summed in float32; the row sum l is taken
    over the unrounded p;
  * the output is float32, (p @ v) / l.

The kernels take the softmax over key tiles with the online (flash)
recurrence, so their rounded p differs from this one's by a factor
exp(m_tile - m_row) before rounding: equal in float32 up to summation
order, within bfloat16's rounding in bfloat16.
"""
from __future__ import annotations

from typing import Optional

import torch

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: torch.Tensor, gate: Optional[torch.Tensor]) -> None:
    """Raise on shapes or devices the function does not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, T, _ = q.shape
    if tuple(bias.shape) != (H, T, T):
        raise ValueError(f"bias must be (H, T, T) = {(H, T, T)}, got "
                         f"{tuple(bias.shape)}")
    if gate is not None and tuple(gate.shape) != (B, H, T):
        raise ValueError(f"gate must be (B, H, T) = {(B, H, T)}, got "
                         f"{tuple(gate.shape)}")
    devices = {x.device for x in (q, k, v, bias, gate) if x is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")


def resolve_kernel_dtype(q: torch.Tensor,
                         kernel_dtype: Optional[torch.dtype]) -> torch.dtype:
    kd = q.dtype if kernel_dtype is None else kernel_dtype
    if kd not in KERNEL_DTYPES:
        raise TypeError(f"kernel dtype must be one of {KERNEL_DTYPES}, "
                        f"got {kd}")
    return kd


def gated_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor,
                          gate: Optional[torch.Tensor] = None, *,
                          sm_scale: float = 1.0,
                          kernel_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """q, k, v (B, H, T, hd); bias (H, T, T) shared across the batch; gate
    (B, H, T) or None. Returns (B, H, T, hd) float32."""
    check_inputs(q, k, v, bias, gate)
    kd = resolve_kernel_dtype(q, kernel_dtype)
    q, k, v, bias = (x.to(kd) for x in (q, k, v, bias))
    if sm_scale != 1.0:
        # a 0-d host tensor: the scale rounded to kd, with no host-to-device
        # copy (which would synchronise the stream)
        q = q * torch.tensor(sm_scale, dtype=kd)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))  # (B, H, T, T)
    if gate is not None:
        s = s + gate.to(kd).float()[..., None] * bias.float()[None]
    else:
        s = s + bias.float()[None]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(kd).float(), v.float()) / l
