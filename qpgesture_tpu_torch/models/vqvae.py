"""Gesture VQ-VAE: 240-frame rotation-matrix windows <-> 30 codebook indices.

Same model family as the reference (codebook/models/vqvae.py:52-302,
Jukebox/Bailando-style, 1 level, x8 temporal downsampling, 512x512
codebook), as one nn.Module whose state_dict keys are the reference's:
``encoders.0.*``, ``decoders.0.*`` and ``bottleneck.level_blocks.0.k``.
``forward`` is the training forward with the reference's losses (L1
reconstruction + commit + velocity L1 + acceleration L1 + optional
smoothness regularizer) and, in training, the in-place EMA update of the
codebook; ``encode``/``decode``/``codebook_signature`` are inference. Public
methods take and return NTC tensors. ``VQVAEConfig.conv_precision`` sets
the precision of every conv (``models/encdec``). With ``levels > 1``,
``encode`` quantises the deepest level and ``decode`` runs the level-0
decoder, as the JAX package does; the training forward then raises, since
the level-0 decoder's output is not the input's length (the JAX
package's ``VQVAE.forward`` fails on the same shapes).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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

    @property
    def codebook_block(self) -> bn.BottleneckBlock:
        """The block holding ``k`` and its EMA statistics."""
        return self.bottleneck.level_blocks[0]

    @torch.no_grad()
    def init_codebook_from_batch(self, x: torch.Tensor,
                                 rng: np.random.RandomState) -> None:
        """Initialize the codebook from random encoder outputs of a batch
        (init_k, bottleneck.py:39-49): rows are tiled with small noise until
        there are at least K of them, then K are drawn without
        replacement; the EMA statistics start afresh. x: (N, T, input_dim);
        draws come from ``rng`` on the host (the trainer draws on the device
        with ``bottleneck.init_codebook``)."""
        h = self.encoders[0](x)
        flat = h.reshape(-1, h.shape[-1]).cpu().numpy()
        K = self.cfg.l_bins
        if flat.shape[0] < K:
            reps = (K + flat.shape[0] - 1) // flat.shape[0]
            flat = np.tile(flat, (reps, 1))
            flat = flat + rng.randn(*flat.shape).astype(np.float32) \
                * (0.01 / np.sqrt(flat.shape[1]))
        k = flat[rng.permutation(flat.shape[0])[:K]]
        self.codebook_block.set_state(torch.as_tensor(
            k, dtype=torch.float32, device=self.device))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
        """Full forward with losses (vqvae.py:187-302). x: (N, T, 135).
        Returns (x_out, loss, metrics), every metric a 0-d tensor on the
        device under the JAX package's name. With ``train`` the codebook
        takes its EMA step in place (dead codes restart from rows drawn
        with ``generator``)."""
        cfg = self.cfg
        if cfg.levels > 1:
            hop0 = cfg.strides_t[0] ** cfg.downs_t[0]
            n_codes = x.shape[1] // cfg.hop_length
            raise ValueError(
                f"levels={cfg.levels}: the training forward decodes with "
                f"the level-0 decoder, which gives {n_codes * hop0} frames "
                f"from the {n_codes} codes of a {x.shape[1]}-frame window, "
                f"not {x.shape[1]}; only encode and decode run at levels > 1")
        h = self.encoders[0](x)
        _, x_d, commit_loss, metrics = self.codebook_block(
            h, mu=cfg.l_mu, train=train, generator=generator)
        x_out = self.decoders[0](x_d)

        def l1(a, b):
            return (a - b).abs().mean()

        acc_out = x_out[:, 2:] + x_out[:, :-2] - 2 * x_out[:, 1:-1]
        recons_loss = l1(x, x_out)
        vel_loss = l1(x_out[:, 1:] - x_out[:, :-1], x[:, 1:] - x[:, :-1])
        acc_loss = l1(acc_out, x[:, 2:] + x[:, :-2] - 2 * x[:, 1:-1])
        regularization = (acc_out ** 2).mean()
        loss = (recons_loss + commit_loss * cfg.commit
                + cfg.reg * regularization + cfg.vel * vel_loss
                + cfg.acc * acc_loss)
        metrics.update(recons_loss=recons_loss, l1_loss=recons_loss,
                       commit_loss=commit_loss, regularization=regularization,
                       velocity_loss=vel_loss, acceleration_loss=acc_loss)
        return x_out, loss, {k: v.detach() for k, v in metrics.items()}

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


def eval_pose_error(x: torch.Tensor, x_out: torch.Tensor,
                    joint_channel: int = 9) -> torch.Tensor:
    """Validation metric: mean per-joint Frobenius error over 9-dim rows
    (train.py:41-45)."""
    b, t, c = x.shape
    diff = (x - x_out).reshape(b, t, c // joint_channel, joint_channel)
    return torch.sqrt((diff ** 2).sum(3)).mean()


def load_vqvae_native(path: str, cfg: VQVAEConfig,
                      device: DeviceLike = "cuda") -> VQVAE:
    """A VQ-VAE from the JAX package's single-file msgpack checkpoint
    (``save_vqvae_native``: ``{"params", "codebook": {k, k_sum, k_elem}}``),
    EMA statistics included."""
    from types import SimpleNamespace

    from ..utils import flax_msgpack
    from .convert import vqvae_state_dict_from_jax
    tree = flax_msgpack.load(path)
    if not (isinstance(tree, dict) and {"params", "codebook"} <= set(tree)):
        raise ValueError(f"{path}: not a VQ-VAE msgpack checkpoint (its top "
                         "level has no 'params' and 'codebook')")
    sd = vqvae_state_dict_from_jax(tree["params"],
                                   SimpleNamespace(**tree["codebook"]), cfg)
    model = VQVAE(cfg, device=device)
    model.load_state_dict(sd)
    return model


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
