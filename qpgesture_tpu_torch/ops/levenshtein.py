"""Edit distance over vq-wav2vec code strings.

The reference computes audio similarity in its hottest loop via
``Levenshtein.distance`` (a C extension) over short code strings
(GestureKNN.py:44-67,677). Code strings are built from the 22-dim stacked
wavvq features: 11 frames x 2 groups; in 'combine' mode each frame becomes one
symbol ``g0*320 + g1`` giving an 11-symbol string (wavvq_distances, mode
'combine'); in 'sum' mode the two group strings are edit-distanced separately
and summed.

``levenshtein_matrix`` here is the plain PyTorch version of the all-pairs
distance matrix: the (Q, N) pairs are the vectorised axis and the L x L DP
recurrence is an unrolled Python loop. It is what the CPU path runs and
what the CUDA kernel (ops/levenshtein_cuda.py) is held against; the engine
calls the kernel's wrapper, never this function directly.
"""
from __future__ import annotations

import numpy as np
import torch


def levenshtein_np(a, b) -> int:
    """Plain DP edit distance between two int sequences (NumPy oracle)."""
    a = list(a)
    b = list(b)
    m, n = len(a), len(b)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def combine_wavvq(feat: np.ndarray, vocab: int = 320) -> np.ndarray:
    """Stacked wavvq feature (..., 2*F) -> combined code string (..., F).

    Matches wavvq_distances mode='combine' (GestureKNN.py:57-61):
    reshape(-1, 2) rows are frames, columns are the two quantizer groups;
    each frame becomes symbol g0*vocab + g1.
    """
    feat = np.asarray(feat)
    frames = feat.reshape(feat.shape[:-1] + (-1, 2))
    return (frames[..., 0] * vocab + frames[..., 1]).astype(np.int32)


def split_wavvq_groups(feat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Stacked wavvq feature (..., 2*F) -> the two per-group strings
    (mode='sum', GestureKNN.py:46-55)."""
    feat = np.asarray(feat)
    frames = feat.reshape(feat.shape[:-1] + (-1, 2))
    return frames[..., 0].astype(np.int32), frames[..., 1].astype(np.int32)


def levenshtein_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs edit distance between code strings.

    a: (Q, L) int32 query strings; b: (N, L) int32 database strings.
    Returns (Q, N) int32 distances. prev[j] (j = 0..L) is DP row i over all
    pairs; the symbol comparison for cell (i, j) is formed when it is used.
    """
    Q, L = a.shape
    N = b.shape[0]
    prev = [torch.full((Q, N), j, dtype=torch.int32, device=a.device)
            for j in range(L + 1)]
    for i in range(L):
        a_i = a[:, i:i + 1]                                   # (Q, 1)
        cur = [torch.full((Q, N), i + 1, dtype=torch.int32, device=a.device)]
        for j in range(1, L + 1):
            cost = (a_i != b[None, :, j - 1]).to(torch.int32)  # (Q, N)
            cur.append(torch.minimum(torch.minimum(prev[j] + 1,
                                                   cur[j - 1] + 1),
                                     prev[j - 1] + cost))
        prev = cur
    return prev[L]


def levenshtein_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """NumPy oracle for levenshtein_matrix."""
    Q, N = a.shape[0], b.shape[0]
    out = np.zeros((Q, N), dtype=np.int32)
    for qi in range(Q):
        for ni in range(N):
            out[qi, ni] = levenshtein_np(a[qi], b[ni])
    return out
