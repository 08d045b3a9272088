"""Rank-sum fusion primitives.

The reference fuses heterogeneous scores by double argsort
(``np.array(d).argsort().argsort()`` — GestureKNN.py:540,553,574): each score
vector is replaced by the rank of each element, and ranks are summed.

Ranks are stable everywhere (ties broken by index), in the NumPy helper and
in the torch rank, so the two are bit-identical. ``torch.sort`` is asked for
``stable=True`` explicitly: its default makes no tie-order promise.
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
