"""Codebook analytics: PCA of signatures, code-frequency histograms,
code <-> word association mining (VisualizeCodebook.py:157-330). A host
(numpy) copy of the JAX package's ``render/analytics.py``."""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def signature_pca(signature: np.ndarray, n_components: int = 2,
                  standardize: bool = True) -> np.ndarray:
    """(K, D) signatures -> (K, n_components) PCA projection
    (visualize_PCA_codebook, VisualizeCodebook.py:157-180)."""
    x = signature.astype(np.float64)
    if standardize:
        std = x.std(axis=0)
        x = (x - x.mean(axis=0)) / np.where(std > 0, std, 1.0)
    else:
        x = x - x.mean(axis=0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:n_components].T


def code_frequency(codes: np.ndarray, top: Optional[int] = None
                   ) -> List[Tuple[int, int]]:
    """Most frequent codes, descending (visualize_code_freq,
    VisualizeCodebook.py:183-203)."""
    counts = Counter(codes.flatten().tolist())
    items = sorted(counts.items(), key=lambda kv: kv[1], reverse=True)
    return items[:top] if top else items


def code_word_association(codes: np.ndarray,
                          slot_words: Sequence[Sequence[str]],
                          min_count: int = 2
                          ) -> Dict[int, List[Tuple[str, int]]]:
    """Mine which words co-occur with each code slot (pick_code_txt,
    VisualizeCodebook.py:276-330). codes: (n, 30); slot_words: per window a
    list of 30 strings (the bucketed context text)."""
    assoc: Dict[int, Counter] = defaultdict(Counter)
    for w in range(codes.shape[0]):
        for s in range(codes.shape[1]):
            text = slot_words[w][s] if s < len(slot_words[w]) else ""
            for word in text.split():
                assoc[int(codes[w, s])][word] += 1
    return {c: [kv for kv in counter.most_common() if kv[1] >= min_count]
            for c, counter in assoc.items()}
