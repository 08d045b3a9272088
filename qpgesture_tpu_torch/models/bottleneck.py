"""Vector-quantization bottleneck: nearest-code assignment and lookup.

Same quantizer as the reference (codebook/models/bottleneck.py:15-186):
nearest code via ||x||^2 - 2 x W^T + ||W||^2. The codebook is the buffer
``bottleneck.level_blocks.0.k`` (bottleneck.py:28), the reference's name.
The EMA codebook update (training) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class BottleneckBlock(nn.Module):
    def __init__(self, k_bins: int, emb_width: int):
        super().__init__()
        self.register_buffer("k", torch.zeros(k_bins, emb_width))


class Bottleneck(nn.Module):
    """Single-level bottleneck holding the (K, D) codebook."""

    def __init__(self, k_bins: int, emb_width: int):
        super().__init__()
        self.level_blocks = nn.ModuleList([BottleneckBlock(k_bins,
                                                           emb_width)])


def quantise(k: torch.Tensor,
             x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest code per row (bottleneck.py:120-126). k: (K, D) codebook;
    x: (M, D). Returns (codes (M,), fit = mean min distance)."""
    k_w = k.T
    distance = ((x ** 2).sum(-1, keepdim=True) - 2.0 * (x @ k_w)
                + (k_w ** 2).sum(0, keepdim=True))
    codes = torch.argmin(distance, dim=-1)
    fit = distance.min(dim=-1).values.mean()
    return codes, fit


def dequantise(k: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    return k[codes.long()]
