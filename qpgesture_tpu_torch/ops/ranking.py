"""Rank-sum fusion primitives.

The reference fuses heterogeneous scores by double argsort
(``np.array(d).argsort().argsort()`` — GestureKNN.py:540,553,574): each score
vector is replaced by the rank of each element, and ranks are summed.

Ranks are stable everywhere (ties broken by index), in the NumPy helper and
in the torch rank, so the two are bit-identical. ``torch.sort`` is asked for
``stable=True`` explicitly: its default makes no tie-order promise. The
distances that feed the ranks sum through ``tree_sum``, a fixed order.
"""
from __future__ import annotations

import numpy as np
import torch


def rank_np(x: np.ndarray) -> np.ndarray:
    """Stable double-argsort rank: rank[i] = position of x[i] in sorted order,
    ties broken by index. Matches np.argsort(kind='stable').argsort()."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty_like(order)
    ranks[order] = np.arange(len(x))
    return ranks


def rank(x: torch.Tensor) -> torch.Tensor:
    """Stable rank along the last axis, int32, on x's device."""
    order = torch.sort(x, dim=-1, stable=True).indices
    n = x.shape[-1]
    pos = torch.arange(n, dtype=torch.int32, device=x.device)
    return torch.empty(x.shape, dtype=torch.int32, device=x.device).scatter_(
        -1, order, pos.expand(x.shape).contiguous())


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` as a fixed binary tree of elementwise adds (at an
    odd length the last entry is added into the first after the level's
    adds): the same IEEE operations in the same order on every device and
    for every batch size, so sums that feed ranks are bit-equal between the
    CPU and the GPU and between a lane and a solo run."""
    n = x.shape[dim]
    while n > 1:
        h = n // 2
        head = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
        if n % 2:
            head.narrow(dim, 0, 1).add_(x.narrow(dim, 2 * h, 1))
        x, n = head, h
    return x.select(dim, 0)
