"""Trained feature extractor for feature-space FGD.

The paper reports "FGD on feature space: 19.921" (BASELINE.md; poster
§4.2), the Yoon et al. (2020) protocol: embed motion windows with a
convolutional autoencoder trained on ground-truth motion, then compute the
Frechet distance between embedding Gaussians. The port of the JAX package's
``render/fgd_extractor.py``:

  * encoder: 4 stride-2 Conv1d (k 5) + LeakyReLU 0.2 -> mean over time ->
    Linear(latent);
  * decoder: Linear -> 4 stride-2 transposed convs (k 5) + LeakyReLU ->
    trim to the window -> 1x1 conv back to the pose channels;
  * MSE-trained on z-normalized ground-truth windows (``train_fgd_extractor``
    / the ``train-fgd`` CLI); the embedding is the encoder's output.

Inputs and outputs are (B, T, C) as in the JAX package; the layers run in
torch's NCT layout with flax's padding. flax's ``padding="SAME"`` at stride
2 pads asymmetrically (lo = total // 2), so each conv pads explicitly; a
flax ``ConvTranspose`` (kernel as stored) equals torch's
``conv_transpose1d`` over the kernel flipped in time with padding 1, trimmed
to twice its input (``models/convert.fgd_state_dict_from_jax`` does the
flip). The parameter names mirror flax's (``enc{i}``, ``to_latent``,
``from_latent``, ``dec{i}``, ``to_pose``).

A checkpoint is a 4-byte little-endian length, the JSON config, then the
port's payload: ``torch.save`` of the state_dict and the normalization
stats. The JAX package writes flax msgpack there; ``load_fgd_extractor``
reads both (``utils/flax_msgpack``).
"""
from __future__ import annotations

import io
import json
from dataclasses import asdict, dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..train.train_vqvae import seeded_init


@dataclass(frozen=True)
class FGDExtractorConfig:
    channels: int = 135      # pose dim
    window: int = 240        # frames per window
    width: int = 64
    latent: int = 32
    conv_layers: int = 4     # each halves time: 240 -> 15


def same_padding(length: int, kernel: int = 5, stride: int = 2
                 ) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one strided conv: (lo, hi)."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


class FGDAutoencoder(nn.Module):
    def __init__(self, cfg: FGDExtractorConfig, device: DeviceLike = "cuda"):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        for i in range(cfg.conv_layers):
            self.add_module(f"enc{i}", nn.Conv1d(
                cfg.channels if i == 0 else w, w, 5, stride=2))
        self.to_latent = nn.Linear(w, cfg.latent)
        self.t0 = -(-cfg.window // (2 ** cfg.conv_layers))
        self.from_latent = nn.Linear(cfg.latent, self.t0 * w)
        for i in range(cfg.conv_layers):
            self.add_module(f"dec{i}", nn.ConvTranspose1d(w, w, 5, stride=2,
                                                          padding=1))
        self.to_pose = nn.Conv1d(w, cfg.channels, 1)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.to_pose.weight.device

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B, latent)."""
        h = x.transpose(1, 2)
        for i in range(self.cfg.conv_layers):
            h = F.pad(h, same_padding(h.shape[-1]))
            h = F.leaky_relu(getattr(self, f"enc{i}")(h), 0.2)
        return self.to_latent(h.mean(-1))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, latent) -> (B, window, C)."""
        h = self.from_latent(z).reshape(z.shape[0], self.t0, self.cfg.width)
        h = h.transpose(1, 2)
        for i in range(self.cfg.conv_layers):
            t = h.shape[-1]
            h = F.leaky_relu(getattr(self, f"dec{i}")(h)[..., :2 * t], 0.2)
        return self.to_pose(h[..., :self.cfg.window]).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.encode(x)
        return self.decode(z), z


def normalize_stats(windows: np.ndarray, data_mean=None, data_std=None):
    """(mean, std clipped at 0.01) as float32, computed over every frame
    of ``windows`` when not given."""
    if data_mean is None:
        flat = windows.reshape(-1, windows.shape[-1])
        data_mean, data_std = flat.mean(axis=0), flat.std(axis=0)
    return (np.asarray(data_mean, np.float32),
            np.clip(np.asarray(data_std, np.float32), 0.01, None))


def train_fgd_extractor(windows: np.ndarray,
                        cfg: Optional[FGDExtractorConfig] = None,
                        epochs: int = 20, batch_size: int = 64,
                        lr: float = 1e-3, seed: int = 0,
                        data_mean: Optional[np.ndarray] = None,
                        data_std: Optional[np.ndarray] = None,
                        log: Callable[[str], None] = print,
                        device: DeviceLike = "cuda"):
    """MSE-train the autoencoder on ground-truth windows (N, T, C) with
    Adam(lr). Returns (model, mean, std). Windows are z-normalized with the
    given (or computed) stats, which the checkpoint keeps for embedding
    time. The epoch order is np.random.RandomState(seed).permutation, as in
    the JAX package; the normalized windows sit on the device and each batch
    is a gather there. The losses are read back once per logged epoch."""
    dev = resolve_device(device)
    windows = np.asarray(windows, np.float32)
    cfg = cfg or FGDExtractorConfig(channels=windows.shape[-1],
                                    window=windows.shape[1])
    data_mean, data_std = normalize_stats(windows, data_mean, data_std)
    normed = torch.from_numpy((windows - data_mean) / data_std).to(dev)
    model = seeded_init(lambda: FGDAutoencoder(cfg, device="cpu"),
                        seed).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)

    n = normed.shape[0]
    order_rng = np.random.RandomState(seed)
    for epoch in range(1, epochs + 1):
        order = torch.from_numpy(order_rng.permutation(n)).to(dev)
        losses = []
        # `or [0]`: fewer windows than one batch -> a single whole-set step
        for i in range(0, n - batch_size + 1, batch_size) or [0]:
            batch = normed[order[i:i + batch_size]]
            loss = F.mse_loss(model(batch)[0], batch)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if epoch == 1 or epoch % 5 == 0 or epoch == epochs:
            log(f"fgd-extractor epoch {epoch}/{epochs}: "
                f"mse {np.mean(torch.stack(losses).cpu().numpy()):.6f}")
    return model.eval(), data_mean, data_std


def save_fgd_extractor(path: str, model: FGDAutoencoder,
                       data_mean: np.ndarray, data_std: np.ndarray) -> None:
    header = json.dumps(asdict(model.cfg)).encode()
    buf = io.BytesIO()
    torch.save({"params": {k: v.detach().cpu()
                           for k, v in model.state_dict().items()},
                "mean": torch.from_numpy(np.asarray(data_mean, np.float32)),
                "std": torch.from_numpy(np.asarray(data_std, np.float32))},
               buf)
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(4, "little"))
        f.write(header)
        f.write(buf.getvalue())


def load_fgd_extractor(path: str, device: DeviceLike = "cuda"):
    """-> (model in eval mode on ``device``, mean, std). Reads the port's
    file (a ``torch.save`` payload after the config header) and the JAX
    package's (flax msgpack of ``{"params", "mean", "std"}`` after the same
    header)."""
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(4), "little")
        cfg = FGDExtractorConfig(**json.loads(f.read(hlen)))
        payload = f.read()
    model = FGDAutoencoder(cfg, device=device)
    if payload.startswith(b"PK\x03\x04"):          # torch.save's zip
        state = torch.load(io.BytesIO(payload), map_location="cpu",
                           weights_only=True)
        model.load_state_dict(state["params"])
        return model.eval(), state["mean"].numpy(), state["std"].numpy()
    from ..models.convert import fgd_state_dict_from_jax
    from ..utils import flax_msgpack
    state = flax_msgpack.unpack(payload)
    model.load_state_dict(fgd_state_dict_from_jax(state["params"], cfg))
    return (model.eval(), np.asarray(state["mean"], np.float32),
            np.asarray(state["std"], np.float32))


def fgd_encoder_fn(model: FGDAutoencoder, mean: np.ndarray, std: np.ndarray
                   ) -> Callable[[np.ndarray], np.ndarray]:
    """-> callable for render.metrics.fgd(encoder=...): (N, T, C) windows ->
    (N, latent) float64 embeddings, normalized with the training stats (std
    clipped at 0.01) on the host and encoded in one batch on the model's
    device."""
    std = np.clip(np.asarray(std, np.float32), 0.01, None)
    mean = np.asarray(mean, np.float32)

    @torch.no_grad()
    def encoder(windows: np.ndarray) -> np.ndarray:
        w = (np.asarray(windows, np.float32) - mean) / std
        z = model.encode(torch.from_numpy(w).to(model.device))
        return z.cpu().numpy().astype(np.float64)

    return encoder
