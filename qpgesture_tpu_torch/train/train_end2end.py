"""GRU-baseline trainer on one GPU: Adam + cross-entropy on codes.

Mirrors codebook/end2end.py:46-137 as the JAX package's
``train/train_end2end.py`` does: Adam(2e-4, betas (0.99, 0.999)),
the mean negative log-likelihood of the VQ-VAE codes under the predicted
logits. In training the WavEncoder's BatchNorms update their running
statistics as flax's do, and the dropout between the GRU layers draws its
masks from the trainer's ``torch.Generator``. A step reads nothing back to
the host; its convolutions run under ``device.cudnn_autotune``.
"""
from __future__ import annotations

import torch

from ..core.config import End2EndConfig
from ..device import DeviceLike, cudnn_autotune, resolve_device, to_device
from ..models.gru_baseline import GeneratorGRU
from .checkpoints import Checkpointed
from .train_vqvae import seeded_init


class End2EndTrainer(Checkpointed):
    """Owns the GeneratorGRU (on ``device``), Adam, the update count and the
    dropout generator."""

    def __init__(self, cfg: End2EndConfig, device: DeviceLike = "cuda",
                 seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = seeded_init(lambda: GeneratorGRU(
            hidden=cfg.hidden_size, output=cfg.output_size, device="cpu"),
            seed).to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg.lr,
                                    betas=tuple(cfg.betas), eps=1e-8)
        self.step = 0

    def _inputs(self, wav, codes):
        return (to_device(wav, self.device, torch.float32),
                to_device(codes, self.device, torch.int64))

    def train_step(self, wav, codes) -> torch.Tensor:
        """One update on (B, 64000) windows and their (B, 30) codes; returns
        the loss as a device tensor."""
        self.model.train()
        with cudnn_autotune():
            _, loss = self.model(*self._inputs(wav, codes),
                                 generator=self.generator)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        self.opt.step()
        self.step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, wav, codes) -> torch.Tensor:
        self.model.eval()
        return self.model(*self._inputs(wav, codes))[1]
