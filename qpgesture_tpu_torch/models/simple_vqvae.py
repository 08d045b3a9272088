"""simpleVQVAE: the VQ-CPC-style alternative quantizer.

The port of the JAX package's ``models/simple_vqvae.py`` (the reference's
codebook/models/simpleVqvae.py:71-226, which nothing in the main path
constructs): a strided conv encoder (240 -> 30 frames) whose half-width
features (``width`` 256 against ``emb_width`` 512) an LSTM refines before a
Dense projection, the EMA codebook of ``models/bottleneck``, and a
conv-transpose decoder. Module names are the JAX package's (``encoder.
conv0`` ... ``decoder.conv_out``), so ``models/convert.
simple_vqvae_state_dict_from_jax`` maps a flax tree name for name; the
LSTM is ``nn.LSTM`` (gates i, f, g, o; flax's one bias per gate is
``bias_ih``, ``bias_hh`` stays 0). Convs, the LSTM and the Dense run in
true float32 (TF32 off), NTC in and out.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import VQVAEConfig
from ..device import DeviceLike, resolve_device
from . import bottleneck as bn


class SimpleEncoder(nn.Module):
    """Three stride-2 Conv1d(k 4, pad 1) + ReLU (240 -> 30), an LSTM over
    the (B, 30, width) features from a zero state, Linear to emb_width."""

    def __init__(self, in_dim: int, width: int = 256, emb_width: int = 512):
        super().__init__()
        self.conv0 = nn.Conv1d(in_dim, width, 4, 2, 1)
        self.conv1 = nn.Conv1d(width, width, 4, 2, 1)
        self.conv2 = nn.Conv1d(width, width, 4, 2, 1)
        self.lstm = nn.LSTM(width, width, batch_first=True)
        self.proj = nn.Linear(width, emb_width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)
        for conv in (self.conv0, self.conv1, self.conv2):
            h = F.relu(conv(h))
        h, _ = self.lstm(h.transpose(1, 2))
        return self.proj(h)


class SimpleDecoder(nn.Module):
    """Conv1d(k 3) + ReLU, three stride-2 ConvTranspose1d(k 4, pad 1) +
    ReLU (30 -> 240), Conv1d(k 3) to the pose channels."""

    def __init__(self, emb_width: int, width: int = 256, out_dim: int = 135):
        super().__init__()
        self.conv_in = nn.Conv1d(emb_width, width, 3, 1, 1)
        self.up0 = nn.ConvTranspose1d(width, width, 4, 2, 1)
        self.up1 = nn.ConvTranspose1d(width, width, 4, 2, 1)
        self.up2 = nn.ConvTranspose1d(width, width, 4, 2, 1)
        self.conv_out = nn.Conv1d(width, out_dim, 3, 1, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv_in(z.transpose(1, 2)))
        for up in (self.up0, self.up1, self.up2):
            h = F.relu(up(h))
        return self.conv_out(h).transpose(1, 2)


class SimpleVQVAE(nn.Module):
    """encode / decode / forward over the EMA codebook, the VQVAE's API:
    ``forward(x, train)`` returns (x_out, loss, metrics) with loss = L1
    reconstruction + commit * commitment, and in training updates the
    codebook in place (dead codes restart from rows drawn with
    ``generator``)."""

    def __init__(self, cfg: VQVAEConfig, width: int = 256,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.cfg = cfg
        self.encoder = SimpleEncoder(cfg.input_dim, width, cfg.emb_width)
        self.decoder = SimpleDecoder(cfg.emb_width, width, cfg.input_dim)
        self.bottleneck = bn.Bottleneck(cfg.l_bins, cfg.emb_width)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.codebook.device

    @property
    def codebook(self) -> torch.Tensor:
        return self.bottleneck.level_blocks[0].k

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 240, C) -> (N, 30) int64 codes."""
        h = self.encoder(x)
        N, T, D = h.shape
        codes, _ = bn.quantise(self.codebook, h.reshape(N * T, D))
        return codes.reshape(N, T)

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(N, 30) codes -> (N, 240, C) poses."""
        return self.decoder(bn.dequantise(self.codebook, codes))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
        h = self.encoder(x)
        _, h_q, commit, metrics = self.bottleneck.level_blocks[0](
            h, mu=self.cfg.l_mu, train=train, generator=generator)
        x_out = self.decoder(h_q)
        recon = (x_out - x).abs().mean()
        loss = recon + self.cfg.commit * commit
        metrics.update(recons_loss=recon, commit_loss=commit)
        return x_out, loss, {k: v.detach() for k, v in metrics.items()}
