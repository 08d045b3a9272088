"""Gesture VQ-VAE: 240-frame rotation-matrix windows <-> 30 codebook indices.

Same model family as the reference (codebook/models/vqvae.py:52-302,
Jukebox/Bailando-style, 1 level, x8 temporal downsampling, 512x512
codebook), as one nn.Module whose state_dict keys are the reference's:
``encoders.0.*``, ``decoders.0.*`` and ``bottleneck.level_blocks.0.k``.
Inference only (encode/decode, ``codebook_signature``); the trainer is not
ported yet. Public
methods take and return NTC tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.config import VQVAEConfig
from ..device import DeviceLike, resolve_device
from . import bottleneck as bn
from .encdec import Decoder, Encoder


class VQVAE(nn.Module):
    def __init__(self, cfg: VQVAEConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoders = nn.ModuleList([Encoder(cfg)])
        self.decoders = nn.ModuleList([Decoder(cfg)])
        self.bottleneck = bn.Bottleneck(cfg.l_bins, cfg.emb_width)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.bottleneck.level_blocks[0].k.device

    @property
    def codebook(self) -> torch.Tensor:
        """(K, D) codebook buffer."""
        return self.bottleneck.level_blocks[0].k

    @torch.no_grad()
    def init_codebook_from_batch(self, x: torch.Tensor,
                                 rng: np.random.RandomState) -> None:
        """Initialize the codebook from random encoder outputs of a batch
        (init_k, bottleneck.py:39-49): rows are tiled with small noise until
        there are at least K of them, then K are drawn without
        replacement. x: (N, T, input_dim); draws come from ``rng``."""
        h = self.encoders[0](x)
        flat = h.reshape(-1, h.shape[-1]).cpu().numpy()
        K = self.cfg.l_bins
        if flat.shape[0] < K:
            reps = (K + flat.shape[0] - 1) // flat.shape[0]
            flat = np.tile(flat, (reps, 1))
            flat = flat + rng.randn(*flat.shape).astype(np.float32) \
                * (0.01 / np.sqrt(flat.shape[1]))
        k = flat[rng.permutation(flat.shape[0])[:K]]
        self.codebook.copy_(torch.as_tensor(k, dtype=torch.float32))

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(N, T, 135) -> (N, T/hop) int64 codes (vqvae.py:174-181)."""
        h = self.encoders[0](x)
        N, T, D = h.shape
        codes, _ = bn.quantise(self.codebook, h.reshape(N * T, D))
        return codes.reshape(N, T)

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(N, Tc) int codes -> (N, Tc*hop, 135) poses (vqvae.py:152-159)."""
        return self.decoders[0](bn.dequantise(self.codebook, codes))


def codebook_signature(model: VQVAE, data_mean: Optional[np.ndarray] = None,
                       data_std: Optional[np.ndarray] = None):
    """Decode every code as a constant 30-code block; signature = mean pose
    over time (VisualizeCodebook.cal_distance:93-116). Returns
    (code (K, 30) int32, poses (K, 240, 135), signature (K, 135)),
    denormalized (std clipped at 0.01) if stats are given."""
    K = model.cfg.l_bins
    codes = np.tile(np.arange(K, dtype=np.int32)[:, None],
                    (1, model.cfg.sample_length))
    poses = model.decode(torch.as_tensor(codes, device=model.device)
                         ).cpu().numpy()
    if data_mean is not None:
        std = np.clip(np.asarray(data_std), 0.01, None)
        poses = poses * std + np.asarray(data_mean)
    return codes, poses, poses.mean(axis=1)
