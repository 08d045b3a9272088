"""Contractions below true float32: bfloat16 / float16 operands with float32
sums and outputs, and bf16x3.

The JAX package's ``"default"`` precision rounds each float32 operand of a
contraction to bfloat16; its ``"high"`` precision (bf16x3) splits each
operand x into hi = bf16(x) and lo = bf16(x - hi) and sums three products,
hi.hi + (hi.lo + lo.hi), dropping lo.lo (~2^-16 relative). WavLM's
projections and convolutions and the matching engine's cosine tables share
these helpers, so that one bf16x3 exists.

On the card every product is one cuBLAS GEMM with a float32 output
(``torch.mm``/``torch.bmm`` with ``out_dtype``): a GEMM that wrote bfloat16
or float16 would round every result by ~1e-3. On the CPU the same rounded
operands are widened exactly and multiplied in float32, so the two differ
only in summation order.
"""
from __future__ import annotations

from typing import Tuple

import torch

# Rows of a low-precision matrix widened to float32 at once by the CPU's
# mm_nt_f32: at most 64 MB of float32, never a copy of a whole database.
CPU_WIDEN_BYTES = 64 << 20


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (M, K) @ (K, N) or (G, M, K) @ (G, K, N) bfloat16 or
    float16 operands, with float32 sums and output: a cuBLAS GEMM that
    writes float32 on the card, a float32 product of the (exactly widened)
    operands on the CPU."""
    mm = torch.mm if a.dim() == 2 else torch.bmm
    if a.is_cuda:
        return mm(a, b, out_dtype=torch.float32)
    return mm(a.float(), b.float())


def mm_nt_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T for (M, K) and (N, K) operands of one 16-bit type, with
    float32 sums and output. b may be a database of any size: the card
    reads it in place, and the CPU widens it CPU_WIDEN_BYTES at a time."""
    if a.is_cuda:
        return torch.mm(a, b.T, out_dtype=torch.float32)
    rows = max(1, CPU_WIDEN_BYTES // (4 * b.shape[1]))
    af = a.float()
    return torch.cat([af @ blk.float().T for blk in torch.split(b, rows)],
                     dim=1)


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo + O(2^-16 |x|): hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def matmul_bf16x3(a: torch.Tensor, b) -> torch.Tensor:
    """float32 a @ b at the "high" precision (bf16x3): a_hi.b_hi + (a_hi.b_lo +
    a_lo.b_hi), three bfloat16 products with float32 sums and outputs. `b`
    is a float32 tensor or its (hi, lo) split (cached weight copies)."""
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b) if isinstance(b, torch.Tensor) else b
    return mm_f32(a_hi, b_hi) + (mm_f32(a_hi, b_lo) + mm_f32(a_lo, b_hi))
