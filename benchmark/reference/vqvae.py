"""The gesture VQ-VAE's decoder (QPGesture's ``codebook/models``:
Jukebox-style ``DecoderConvBock`` with dilated residual blocks and
transposed convolutions, then the output conv) in plain PyTorch: codes ->
poses. Weights are a dict under the reference implementation's names
(``decoders.0.*``, ``bottleneck.level_blocks.0.k``)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def decode(w: Weights, cfg: dict, codes: torch.Tensor) -> torch.Tensor:
    """(N, Tc) int codes -> (N, Tc * stride ** down, input_dim) float32."""
    h = w["bottleneck.level_blocks.0.k"][codes].transpose(1, 2)  # (N, D, T)
    pre = "decoders.0.level_blocks.0.model"
    h = F.conv1d(h, w[f"{pre}.0.weight"], w[f"{pre}.0.bias"], padding=1)
    depth, growth = cfg["depth"], cfg["dilation_growth_rate"]
    stride = cfg["stride_t"]
    for i in range(cfg["down_t"]):
        blk = f"{pre}.{i + 1}"
        # residual blocks in reversed dilation order (reverse_decoder_dilation)
        for j in range(depth):
            dil = growth ** (depth - 1 - j)
            r = f"{blk}.0.model.{j}.model"
            y = F.conv1d(F.relu(h), w[f"{r}.1.weight"], w[f"{r}.1.bias"],
                         padding=dil, dilation=dil)
            h = h + F.conv1d(F.relu(y), w[f"{r}.3.weight"], w[f"{r}.3.bias"])
        h = F.conv_transpose1d(h, w[f"{blk}.1.weight"], w[f"{blk}.1.bias"],
                               stride=stride, padding=stride // 2)
    h = F.conv1d(h, w["decoders.0.out.weight"], w["decoders.0.out.bias"],
                 padding=1)
    return h.transpose(1, 2)
