"""ResyncNet: the 1-D UNet generator that "resyncs" KNN output motion to the
audio (inference path).

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

Inference only: BatchNorm runs on its running statistics (eps 1e-5) and
the convolutions in true float32 (TF32 off package-wide). The WGAN-GP
discriminator and its gradient penalty belong to training, which is not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import constants as C
from ..device import DeviceLike, resolve_device

N_MFCC = 13


def double_conv(in_channels: int, out_channels: int) -> nn.Sequential:
    """The reference's double_conv (model.py:20-29)."""
    return nn.Sequential(
        nn.Conv1d(in_channels, out_channels, 3, padding=1),
        nn.BatchNorm1d(out_channels), nn.LeakyReLU(0.2),
        nn.Conv1d(out_channels, out_channels, 3, padding=1),
        nn.BatchNorm1d(out_channels), nn.LeakyReLU(0.2))


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
