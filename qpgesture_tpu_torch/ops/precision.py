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


def split_operands(x: torch.Tensor, precision: str):
    """The bfloat16 operand(s) of x: (hi,) at "default", (hi, lo) at
    "high"."""
    return (x.to(torch.bfloat16),) if precision == "default" \
        else split_bf16(x)


def product_f32(a, b) -> torch.Tensor:
    """Sum of the products of two splits with float32 sums and output: one
    product of (hi,) operands, bf16x3's three of (hi, lo) operands."""
    if len(a) == 1:
        return mm_f32(a[0], b[0])
    return mm_f32(a[0], b[0]) + (mm_f32(a[0], b[1]) + mm_f32(a[1], b[0]))


class _LowPrecisionMatmul(torch.autograd.Function):
    """a @ b at "default" or "high" whose backward products run at the same
    precision (JAX's VJP of a dot or a conv keeps its precision): da =
    g @ b^T and db = a^T @ g, g rounded as the operands are. The bfloat16
    operands are what is saved for the backward pass."""

    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.precision = precision
        sa, sb = split_operands(a, precision), split_operands(b, precision)
        ctx.save_for_backward(*sa, *sb)
        ctx.n = len(sa)
        return product_f32(sa, sb)

    @staticmethod
    def backward(ctx, g):
        saved, n = ctx.saved_tensors, ctx.n
        sa, sb = saved[:n], saved[n:]
        sg = split_operands(g.contiguous(), ctx.precision)
        da = product_f32(sg, [t.t() for t in sb]) \
            if ctx.needs_input_grad[0] else None
        db = product_f32([t.t() for t in sa], sg) \
            if ctx.needs_input_grad[1] else None
        return da, db, None


def matmul_lp(a: torch.Tensor, b: torch.Tensor,
              precision: str) -> torch.Tensor:
    """float32 (M, K) @ (K, N) at ``precision``: "default" rounds both
    operands to bfloat16, "high" is bf16x3, each with float32 sums and
    output and a gradient whose products are rounded the same way."""
    return _LowPrecisionMatmul.apply(a, b, precision)
