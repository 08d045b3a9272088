"""Vector-quantization bottleneck with the EMA codebook.

Same quantizer as the reference (codebook/models/bottleneck.py:15-186):
nearest code via ||x||^2 - 2 x W^T + ||W||^2, the straight-through
estimator, EMA codebook statistics (mu=0.99) with dead-code random
restarts, and the codebook health metrics (fit / pn / entropy / used_curr /
usage / dk). The codebook is the buffer ``bottleneck.level_blocks.0.k``
(bottleneck.py:28), the reference's name. Its EMA statistics ``k_sum`` and
``k_elem`` are non-persistent buffers: a reference ``.bin`` holds only
``k`` and loads with ``load_state_dict``; a state_dict that does carry
them (a JAX train state through ``convert.vqvae_state_dict_from_jax``)
loads them too, and the trainer's checkpoint stores them explicitly.

One device: the JAX package's cross-replica psum of the batch statistics
and all-gather of the restart candidates have no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn


class BottleneckBlock(nn.Module):
    def __init__(self, k_bins: int, emb_width: int):
        super().__init__()
        self.register_buffer("k", torch.zeros(k_bins, emb_width))
        self.register_buffer("k_sum", torch.zeros(k_bins, emb_width),
                             persistent=False)
        self.register_buffer("k_elem", torch.ones(k_bins), persistent=False)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        # the EMA statistics load when the state_dict carries them
        for name in ("k_sum", "k_elem"):
            value = state_dict.pop(prefix + name, None)
            if value is not None:
                with torch.no_grad():
                    getattr(self, name).copy_(value)
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)

    @torch.no_grad()
    def set_state(self, k: torch.Tensor, k_sum: Optional[torch.Tensor] = None,
                  k_elem: Optional[torch.Tensor] = None) -> None:
        """Set the codebook; the EMA statistics default to a fresh start
        (k_sum = k, k_elem = 1), as ``init_codebook`` leaves them."""
        self.k.copy_(k)
        self.k_sum.copy_(k if k_sum is None else k_sum)
        if k_elem is None:
            self.k_elem.fill_(1.0)
        else:
            self.k_elem.copy_(k_elem)

    def forward(self, x: torch.Tensor, *, mu: float, train: bool,
                generator: Optional[torch.Generator] = None):
        """Quantise / dequantise with the straight-through estimator, and in
        training the in-place EMA update of the codebook. x: (N, T, D).
        Returns (codes (N, T), x_d (N, T, D), commit_loss, metrics)."""
        N, T, D = x.shape
        flat = x.reshape(N * T, D)
        flat_d = flat.detach()
        metrics: Dict[str, torch.Tensor] = {}
        metrics["pn"] = prenorm(flat_d)
        codes, metrics["fit"] = quantise(self.k, flat_d)
        x_d = dequantise(self.k, codes)
        if train:
            state, upd = update_codebook(
                (self.k, self.k_sum, self.k_elem), flat_d, codes, mu,
                generator=generator)
            self.set_state(*state)
            metrics.update(upd)
        commit_loss = ((x_d - flat) ** 2).sum() / (N * T * D)
        # straight-through; in eval the reference also detaches the output
        # (bottleneck.py:221-225)
        x_d = flat + (x_d - flat).detach()
        if not train:
            x_d = x_d.detach()
        return codes.reshape(N, T), x_d.reshape(N, T, D), commit_loss, \
            metrics


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


def prenorm(x: torch.Tensor) -> torch.Tensor:
    """||x - mean(x)|| / sqrt(numel) (bottleneck.py:102)."""
    return torch.linalg.vector_norm(x - x.mean()) / (x.numel() ** 0.5)


def _tile_to_k(x: torch.Tensor, k_bins: int,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Repeat rows (with noise of std 0.01/sqrt(D)) until there are at least
    k_bins candidates (bottleneck.py:30-37)."""
    d, ew = x.shape
    if d < k_bins:
        x = x.repeat((k_bins + d - 1) // d, 1)
        x = x + torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype) * (0.01 / ew ** 0.5)
    return x


def restart_candidates(x: torch.Tensor, k_bins: int,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """k_bins rows drawn without replacement from the (tiled) batch: the
    candidates of a codebook (re)initialization. The permutation is an
    argsort of uniform draws, so it stays on the device."""
    y = _tile_to_k(x, k_bins, generator)
    u = torch.rand(y.shape[0], generator=generator, device=y.device)
    return y[torch.argsort(u)[:k_bins]]


def init_codebook(x: torch.Tensor, k_bins: int,
                  generator: Optional[torch.Generator] = None):
    """Codebook from random rows of the first batch's encoder outputs
    (init_k, bottleneck.py:39-49). x: (M, D). Returns (k, k_sum, k_elem)
    with k_sum = k and k_elem = 1."""
    k = restart_candidates(x, k_bins, generator)
    return k, k.clone(), torch.ones(k_bins, dtype=x.dtype, device=x.device)


def update_codebook(state, x: torch.Tensor, codes: torch.Tensor, mu: float,
                    *, generator: Optional[torch.Generator] = None,
                    threshold: float = 1.0,
                    k_rand: Optional[torch.Tensor] = None):
    """EMA update + dead-code restart (update_k, bottleneck.py:63-94).

    state: (k (K, D), k_sum (K, D), k_elem (K,)); x: (M, D) encoder outputs;
    codes: (M,). A code whose k_elem falls below ``threshold`` restarts at
    a row of ``k_rand`` (K, D), by default ``restart_candidates`` of x drawn
    from ``generator``. Returns ((k, k_sum, k_elem), metrics); nothing is
    read back to the host.
    """
    k_old, k_sum_old, k_elem_old = state
    k_bins = k_old.shape[0]
    with torch.no_grad():
        # (M, K); a comparison, not F.one_hot, whose bounds check would
        # read the codes back on some devices
        onehot = (codes[:, None] == torch.arange(
            k_bins, device=codes.device)).to(x.dtype)
        _k_sum = onehot.T @ x
        _k_elem = onehot.sum(0)
        if k_rand is None:
            k_rand = restart_candidates(x, k_bins, generator)
        k_sum = mu * k_sum_old + (1.0 - mu) * _k_sum
        k_elem = mu * k_elem_old + (1.0 - mu) * _k_elem
        usage = (k_elem[:, None] >= threshold).to(x.dtype)
        k = usage * (k_sum / torch.clamp(k_elem[:, None], min=1e-12)) \
            + (1 - usage) * k_rand
        _k_prob = _k_elem / torch.clamp(_k_elem.sum(), min=1e-12)
        metrics = dict(
            entropy=-(_k_prob * torch.log(_k_prob + 1e-8)).sum(),
            used_curr=(_k_elem >= threshold).to(torch.float32).sum(),
            usage=usage.sum(),
            dk=torch.linalg.vector_norm(k - k_old) / (k_old.numel() ** 0.5))
    return (k, k_sum, k_elem), metrics
