"""Periodic Autoencoder (DeepPhase-style) for the phase manifold.

Same model as the reference (codebook/PAE.py:50-162), with its parameter
names (``conv1``, ``bn_conv1``, ``conv2``, ``bn_conv2``, ``fc.{i}``,
``bn.{i}``, ``deconv1``, ``bn_deconv1``, ``deconv2``), so a reference
checkpoint loads with ``load_state_dict`` (``convert.load_pae_checkpoint``):
two wide convs embed 240-frame joint-velocity windows into 8 latent
channels; per channel an FFT gives (frequency, amplitude, offset) and a
Linear(240->2) + atan2 head gives the phase; the latent is rebuilt as
a*sin(2pi*(f*t+p))+b and deconvolved back.

``PhaseExtractor`` is the per-frame phase database construction (pose2phase,
PAE.py:477-508): one stride-1 window per motion frame, batched, with the
velocity array uploaded once and the windows gathered on the device. It
stops after the phase heads; the decoder half does not feed the phases.
The convolutions are true float32 (TF32 off): the phases feed the matching
engine's phase-continuity ranks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import PAEConfig
from ..device import DeviceLike, resolve_device


class PAE(nn.Module):
    def __init__(self, cfg: PAEConfig, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        t = cfg.frames
        inter = cfg.input_channels // cfg.channels_per_joint
        pc = cfg.phase_channels
        self.conv1 = nn.Conv1d(cfg.input_channels, inter, t, 1, int(t / 2))
        self.bn_conv1 = nn.BatchNorm1d(inter)
        self.conv2 = nn.Conv1d(inter, pc, t, 1, int((t - 1) / 2))
        self.bn_conv2 = nn.BatchNorm1d(pc)
        self.fc = nn.ModuleList([nn.Linear(t, 2) for _ in range(pc)])
        self.bn = nn.ModuleList([nn.BatchNorm1d(2) for _ in range(pc)])
        self.deconv1 = nn.Conv1d(pc, inter, t, 1, int((t - 1) / 2))
        self.bn_deconv1 = nn.BatchNorm1d(inter)
        self.deconv2 = nn.Conv1d(inter, cfg.input_channels, t, 1, int(t / 2))
        # rfftfreq(T)[1:] * (T * time_scale) / window and the signal's time
        # axis (PAE.py:62-66), float64 on the host then float32
        freqs = np.fft.rfftfreq(t)[1:] * (t * self.time_scale) / cfg.window
        self.register_buffer("freqs", torch.tensor(freqs, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("args", torch.from_numpy(np.linspace(
            -cfg.window / 2, cfg.window / 2, t, dtype=np.float32)),
            persistent=False)
        self.eval()
        self.to(dev)

    @property
    def time_scale(self) -> float:
        return self.cfg.keys / self.cfg.frames

    @property
    def device(self) -> torch.device:
        return self.conv1.weight.device

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C_in, T) velocity windows -> (N, C, T) latent."""
        y = torch.tanh(self.bn_conv1(self.conv1(x)))
        return torch.tanh(self.bn_conv2(self.conv2(y)))

    def fft_params(self, y: torch.Tensor):
        """Per-channel frequency/amplitude/offset from the latent spectrum
        (PAE.FFT, PAE.py:99-115). y: (N, C, T) -> three (N, C)."""
        rfft = torch.fft.rfft(y, dim=2)
        power = rfft.abs()[:, :, 1:] ** 2               # drop DC
        freq = (torch.sum(self.freqs * power, dim=2)
                / torch.sum(power, dim=2) / self.time_scale)
        amp = 2.0 * torch.sqrt(torch.sum(power, dim=2)) / self.cfg.frames
        offset = rfft.real[:, :, 0] / self.cfg.frames
        return freq, amp, offset

    def phase(self, y: torch.Tensor) -> torch.Tensor:
        """Per-channel phase heads: Linear(T->2) + BatchNorm + atan2 / 2pi.
        y: (N, C, T) -> (N, C) in [-0.5, 0.5]."""
        ps = []
        for i in range(self.cfg.phase_channels):
            v = self.bn[i](self.fc[i](y[:, i, :]))
            ps.append(torch.atan2(v[:, 1], v[:, 0]) / (2.0 * np.pi))
        return torch.stack(ps, dim=1)

    def phase_params(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C_in, T) velocity windows -> (N, 4, C): [p, f, a, b] per
        channel, the encoder half and the heads only."""
        y = self.encode(x)
        f, a, b = self.fft_params(y)
        return torch.stack([self.phase(y), f, a, b], dim=1)

    def forward(self, x: torch.Tensor):
        """x: (N, T*C_in) flattened velocity windows in the reference's
        channel-major layout (reshape to (N, C_in, T), PAE.py:120). Returns
        what the JAX package's PAE returns: (y (N, T*C_in), latent (N, T, C),
        signal (N, C, T), (p, f, a, b) each (N, C, 1))."""
        cfg = self.cfg
        N = x.shape[0]
        y = self.encode(x.reshape(N, cfg.input_channels, cfg.frames))
        latent = y.transpose(1, 2)
        f, a, b = self.fft_params(y)
        p = self.phase(y)
        params = (p[..., None], f[..., None], a[..., None], b[..., None])
        signal = (params[2] * torch.sin(
            2.0 * np.pi * (params[1] * self.args + params[0])) + params[3])
        y = torch.tanh(self.bn_deconv1(self.deconv1(signal)))
        y = self.deconv2(y).reshape(N, cfg.input_channels * cfg.frames)
        return y, latent, signal, params


def velocity_input(pose_window: torch.Tensor) -> torch.Tensor:
    """(N, T, C) pose window -> flattened frame-difference velocities with a
    leading zero frame, channel-major (PAE.py:367-370)."""
    vel = pose_window[:, 1:] - pose_window[:, :-1]
    vel = F.pad(vel, (0, 0, 1, 0))
    return vel.transpose(1, 2).reshape(pose_window.shape[0], -1)


class PhaseExtractor:
    """Batched pose2phase (PAE.py:477-508): per-frame phase parameters from
    a centered sliding velocity window, on ``device``."""

    def __init__(self, model: PAE, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def phases_at(self, vel: torch.Tensor, start: int, stop: int
                  ) -> torch.Tensor:
        """(stop-start, 4, C) phase parameters of the windows starting at
        rows start..stop-1 of the padded velocity array ``vel`` (on the
        device): window i is a zero row and then vel[i : i+T-1] (the
        reference feeds T-1 velocity rows to fill its T-frame window)."""
        t = self.model.cfg.frames
        win = vel[start:stop + t - 2].unfold(0, t - 1, 1)   # (B, C, T-1)
        return self.model.phase_params(F.pad(win, (1, 0)))

    def velocity(self, pose: np.ndarray, data_mean: np.ndarray,
                 data_std: np.ndarray) -> torch.Tensor:
        """Normalised frame-difference velocities, padded 120 / 119 rows
        (whatever the window length, as the JAX package pads), uploaded
        once: (T + 238, C_in) float32 on the device."""
        std = np.clip(data_std, 0.01, None)
        pose = (pose - data_mean) / std
        vel = np.pad(pose[1:] - pose[:-1], ((120, 119), (0, 0)))
        return torch.as_tensor(vel.astype(np.float32), device=self.device)

    def pose_to_phase(self, pose: np.ndarray, data_mean: np.ndarray,
                      data_std: np.ndarray, batch: int = 1024) -> np.ndarray:
        """pose: (T, 135) raw rotations. Returns (T, 4, 8) dense phase."""
        vel = self.velocity(pose, data_mean, data_std)
        n = pose.shape[0]
        out = torch.empty((n, 4, self.model.cfg.phase_channels),
                          device=self.device)
        for s in range(0, n, batch):
            e = min(s + batch, n)
            out[s:e] = self.phases_at(vel, s, e)
        return out.cpu().numpy()
