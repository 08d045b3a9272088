"""ResyncNet: the 1-D UNet generator that "resyncs" KNN output motion to the
audio, and the WGAN-GP critic it is trained against.

The port of ``qpgesture_tpu/models/resync.py``'s generator, with the
reference's parameter names (Speech2GestureMatching/model.py:20-93), so a
reference ``best_model.pth`` loads with ``load_state_dict``
(``models/convert.load_resync_checkpoint``): ``dconv_down{1..4}`` and
``dconv_up{3,2,1}`` are each a Sequential of (Conv1d, BatchNorm1d,
LeakyReLU(0.2)) twice, with the convs at ``.0`` / ``.3`` and the norms at
``.1`` / ``.4``; ``conv_last`` is the 1x1 output conv. The UNet goes down
128/256/256/512 with average-pool halving (an odd last frame is dropped,
as the JAX package's ``avg_pool1d`` drops it) and back up with nearest
upsampling and [upsampled, skip] concatenation.

The BatchNorms are ``models/batchnorm.BatchNorm1d`` (eps 1e-5): in eval
they run on their running statistics, in training they move them as flax's
BatchNorm (momentum 0.9) does, towards the biased batch variance. The
convolutions run in true float32 (TF32 off package-wide).

The critic, ``Discriminator`` (model.py:96-117), is three InstanceNorm double
convs (512/256/128, LeakyReLU 0.2, average-pool halving) and a bias-free
Linear over the flattened (128, T/8) map, in the reference's NCT layout;
the JAX package names its parts ``d1``/``d2``/``d3``/``critic``, and so does
the port. ``gradient_penalty`` is the WGAN-GP interpolation penalty
(train_resync_gestureknn.py:38-105), a double backward through the critic.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import constants as C
from ..device import DeviceLike, resolve_device
from .batchnorm import BatchNorm1d

N_MFCC = 13


def double_conv(in_channels: int, out_channels: int) -> nn.Sequential:
    """The reference's double_conv (model.py:20-29)."""
    return nn.Sequential(
        nn.Conv1d(in_channels, out_channels, 3, padding=1),
        BatchNorm1d(out_channels), nn.LeakyReLU(0.2),
        nn.Conv1d(out_channels, out_channels, 3, padding=1),
        BatchNorm1d(out_channels), nn.LeakyReLU(0.2))


class ResyncNet(nn.Module):
    """(B, in_features, T) -> (B, out_features, T): MFCC | motion channels in,
    resynced motion out, in the reference's NCT layout."""

    def __init__(self, in_features: int = N_MFCC + C.NUM_JOINTS,
                 out_features: int = C.NUM_JOINTS,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.dconv_down1 = double_conv(in_features, 128)
        self.dconv_down2 = double_conv(128, 256)
        self.dconv_down3 = double_conv(256, 256)
        self.dconv_down4 = double_conv(256, 512)
        self.dconv_up3 = double_conv(512 + 256, 256)
        self.dconv_up2 = double_conv(256 + 256, 256)
        self.dconv_up1 = double_conv(256 + 128, 256)
        self.conv_last = nn.Conv1d(256, out_features, 1)
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.conv_last.weight.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def up(x):
            return x.repeat_interleave(2, dim=-1)

        c1 = self.dconv_down1(x)
        c2 = self.dconv_down2(F.avg_pool1d(c1, 2))
        c3 = self.dconv_down3(F.avg_pool1d(c2, 2))
        x = self.dconv_down4(F.avg_pool1d(c3, 2))
        x = self.dconv_up3(torch.cat((up(x), c3), 1))
        x = self.dconv_up2(torch.cat((up(x), c2), 1))
        x = self.dconv_up1(torch.cat((up(x), c1), 1))
        return self.conv_last(x)


class InstanceNorm1d(nn.InstanceNorm1d):
    """InstanceNorm1d(affine=True) written out: each (sample, channel) is
    normalized over time with the biased variance and eps 1e-5, as the JAX
    package's DoubleConv(norm="instance") does, in elementwise operations
    that the gradient penalty differentiates twice on every device. Keeps
    torch's parameter names."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * self.weight[:, None] + self.bias[:, None]


def instance_double_conv(in_channels: int, out_channels: int
                         ) -> nn.Sequential:
    """The critic's double conv: double_conv with InstanceNorm, the convs
    at .0 / .3 and the norms at .1 / .4."""
    return nn.Sequential(
        nn.Conv1d(in_channels, out_channels, 3, padding=1),
        InstanceNorm1d(out_channels), nn.LeakyReLU(0.2),
        nn.Conv1d(out_channels, out_channels, 3, padding=1),
        InstanceNorm1d(out_channels), nn.LeakyReLU(0.2))


class Discriminator(nn.Module):
    """(B, in_features, T) MFCC | motion -> (B, 1) critic scores."""

    def __init__(self, in_features: int = N_MFCC + C.NUM_JOINTS,
                 num_frames: int = C.NUM_FRAMES,
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.d1 = instance_double_conv(in_features, 512)
        self.d2 = instance_double_conv(512, 256)
        self.d3 = instance_double_conv(256, 128)
        self.critic = nn.Linear(128 * (num_frames // 8), 1, bias=False)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.avg_pool1d(self.d1(x), 2)
        x = F.avg_pool1d(self.d2(x), 2)
        x = F.avg_pool1d(self.d3(x), 2)
        return self.critic(x.reshape(x.shape[0], -1))


def gradient_penalty(disc: Discriminator, real: torch.Tensor,
                     fake: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """mean((||d critic / d interp|| - 1)^2) at interp = eps * real + (1 -
    eps) * fake, the norm per sample over (C, T) with 1e-12 under the root.
    ``eps`` (B, 1, 1) is the caller's draw. The points are constants (as the
    JAX package's stopped fakes); the graph of their gradient is kept, so
    the penalty's gradient reaches the critic's parameters."""
    interp = (eps * real + (1 - eps) * fake).detach().requires_grad_(True)
    grads, = torch.autograd.grad(disc(interp).sum(), interp,
                                 create_graph=True)
    norms = torch.sqrt((grads ** 2).sum((1, 2)) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


def resync_stats(mfcc: np.ndarray, motion: np.ndarray):
    """Per-channel mean/std over (seq, time), calc_data_stats semantics
    (data_processing.py:172-182). mfcc: (N, T, n_mfcc) raw train-db
    features; motion: (N, T, J). Returns (mfcc_mean, mfcc_std, motion_mean,
    motion_std), each (C,) float32."""
    out = []
    for feat in (mfcc, motion):
        feat = np.asarray(feat, np.float32)
        out += [feat.mean(axis=(0, 1)), feat.std(axis=(0, 1))]
    return tuple(out)


@torch.no_grad()
def predict_resynced_gesture(gen: ResyncNet, mfcc: np.ndarray,
                             knn_motion: np.ndarray, mfcc_mean, mfcc_std,
                             motion_mean, motion_std) -> np.ndarray:
    """Apply a trained ResyncNet to KNN output motion, the reference's
    predict_resynced_gesture (ResyncGestureKNN.py:43-87): normalize the
    test MFCCs with the train-db audio stats and the KNN motion with the
    train-db motion stats (on the host, as the JAX package does), run the
    generator over every sequence in one batch on its device, and
    denormalize back to motion space there.

    mfcc: (N, T, n_mfcc) raw test features; knn_motion: (N, T, J) raw KNN
    motion. Returns (N, T, J) resynced motion (float32)."""
    if gen.training:
        raise ValueError("ResyncNet must be in eval mode (BatchNorm on its "
                         "running statistics)")
    mfcc = np.asarray(mfcc, np.float32)
    knn_motion = np.asarray(knn_motion, np.float32)
    eps = np.float32(1e-8)  # utils.normalize_data (utils.py:8-9)
    mfcc_n = (mfcc - np.asarray(mfcc_mean, np.float32)) / (
        np.asarray(mfcc_std, np.float32) + eps)
    mmean = np.asarray(motion_mean, np.float32)
    mstd = np.asarray(motion_std, np.float32)
    motion_n = (knn_motion - mmean) / (mstd + eps)
    x = torch.from_numpy(np.concatenate([mfcc_n, motion_n], axis=-1)).to(
        gen.device)
    out = gen(x.transpose(1, 2)).transpose(1, 2)
    # inv_normalize_data (utils.py:12-13): no eps on the way back
    out = out * torch.from_numpy(mstd).to(gen.device) + \
        torch.from_numpy(mmean).to(gen.device)
    return out.cpu().numpy()
