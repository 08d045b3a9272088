"""Evaluation metrics: Hellinger distance and Frechet Gesture Distance.

The paper reports Hellinger distance between velocity histograms and FGD on
feature/raw spaces (BASELINE.md; the reference repo itself ships no metric
code — SURVEY §5). Implemented here from the published definitions
(Kucherenko et al. for Hellinger-on-velocity-histograms, Yoon et al. for
FGD), so the framework can score itself on BEAT-style data.

A copy of the JAX package's ``render/metrics.py`` (NumPy only), so the
port's scores are bit-equal to it on the same arrays.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def velocity_histogram(poses: np.ndarray, bins: np.ndarray) -> np.ndarray:
    """Per-channel histogram of frame-to-frame absolute velocities.
    poses: (T, C); returns (C, len(bins)-1) normalized to sum 1."""
    vel = np.abs(np.diff(poses, axis=0))
    hists = np.stack([np.histogram(vel[:, c], bins=bins)[0]
                      for c in range(vel.shape[1])]).astype(np.float64)
    sums = hists.sum(axis=1, keepdims=True)
    return hists / np.maximum(sums, 1e-12)


def hellinger(p: np.ndarray, q: np.ndarray) -> float:
    """H(p, q) = sqrt(1 - sum(sqrt(p*q))), averaged over leading dims."""
    bc = np.sqrt(np.clip(p, 0, None) * np.clip(q, 0, None)).sum(axis=-1)
    return float(np.mean(np.sqrt(np.clip(1.0 - bc, 0.0, None))))


def hellinger_velocity(poses_a: np.ndarray, poses_b: np.ndarray,
                       n_bins: int = 50) -> float:
    """Average Hellinger distance between the per-channel velocity
    histograms of two motion streams (the paper's table metric)."""
    vmax = max(np.abs(np.diff(poses_a, axis=0)).max(),
               np.abs(np.diff(poses_b, axis=0)).max(), 1e-6)
    bins = np.linspace(0.0, vmax, n_bins + 1)
    return hellinger(velocity_histogram(poses_a, bins),
                     velocity_histogram(poses_b, bins))


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(feat_a: np.ndarray, feat_b: np.ndarray) -> float:
    """Frechet distance between Gaussians fit to two feature sets
    (N_a, D), (N_b, D): |mu_a-mu_b|^2 + Tr(Ca + Cb - 2 (Ca Cb)^1/2).

    When D exceeds the sample count (raw-space FGD on flattened motion
    windows: D = T*C can be tens of thousands), the D x D covariances are
    never formed.  The covariances have rank < N, and the nonzero
    eigenvalues of Ca Cb = A^T A B^T B equal those of (A B^T)(B A^T), so
    Tr((Ca Cb)^1/2) is the nuclear norm of the small N_a x N_b cross-Gram
    A B^T -- exact, O(N^2 D) instead of O(D^3)."""
    feat_a = np.asarray(feat_a, dtype=np.float64)
    feat_b = np.asarray(feat_b, dtype=np.float64)
    mu_a, mu_b = feat_a.mean(0), feat_b.mean(0)
    na, nb = feat_a.shape[0], feat_b.shape[0]
    d = feat_a.shape[1]
    mean_term = float(((mu_a - mu_b) ** 2).sum())
    if d > na + nb:
        a = (feat_a - mu_a) / np.sqrt(max(na - 1, 1))
        b = (feat_b - mu_b) / np.sqrt(max(nb - 1, 1))
        tr_cross = float(np.linalg.svd(a @ b.T, compute_uv=False).sum())
        return mean_term + float((a * a).sum() + (b * b).sum()) \
            - 2.0 * tr_cross
    ca = np.cov(feat_a, rowvar=False)
    cb = np.cov(feat_b, rowvar=False)
    sa = _sqrtm_psd(ca)
    covmean = _sqrtm_psd(sa @ cb @ sa)
    return float(mean_term
                 + np.trace(ca) + np.trace(cb) - 2.0 * np.trace(covmean))


def fgd(windows_a: np.ndarray, windows_b: np.ndarray,
        encoder: Optional[Callable[[np.ndarray], np.ndarray]] = None
        ) -> float:
    """Frechet Gesture Distance between two sets of motion windows
    (N, T, C). encoder=None gives raw-data-space FGD (flattened windows);
    pass a feature extractor (e.g. a trained autoencoder's encode fn) for
    feature-space FGD."""
    if encoder is None:
        fa = windows_a.reshape(windows_a.shape[0], -1)
        fb = windows_b.reshape(windows_b.shape[0], -1)
    else:
        fa = np.asarray(encoder(windows_a))
        fb = np.asarray(encoder(windows_b))
    return frechet_distance(fa, fb)
