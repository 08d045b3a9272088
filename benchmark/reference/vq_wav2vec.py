"""vq-wav2vec (Baevski et al., 2020, "vq-wav2vec: Self-Supervised Learning
of Discrete Speech Representations") in plain PyTorch, the inference path
that turns a 4 s window into Gumbel codes (fairseq's ``Wav2VecModel``
feature extractor and ``GumbelVectorQuantizer.forward_idx``).

Weights are a dict of tensors under fairseq's parameter names.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def logits(w: Weights, cfg: dict, wav: torch.Tensor) -> torch.Tensor:
    """(B, n_samples) float32 -> (B, frames, groups, vars) float32 logits
    of the quantizer's weight projection."""
    h = wav[:, None, :]
    for i, (dim, k, s) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"],
                                        cfg["conv_stride"])):
        pre = f"feature_extractor.conv_layers.{i}"
        h = F.conv1d(h, w[pre + ".0.weight"], None, stride=s)
        h = F.group_norm(h, 1, w[pre + ".2.weight"], w[pre + ".2.bias"],
                         cfg["group_norm_eps"])
        h = F.gelu(h)
    if cfg["log_compression"]:
        h = torch.log(h.abs() + 1)
    z = h.transpose(1, 2)                                    # (B, T, C)
    for d in range(cfg["vq_depth"] - 1):
        pre = f"vector_quantizer.weight_proj.{d}.0"
        z = F.gelu(F.linear(z, w[pre + ".weight"], w[pre + ".bias"]))
    last = f"vector_quantizer.weight_proj.{cfg['vq_depth'] - 1}" \
        if cfg["vq_depth"] > 1 else "vector_quantizer.weight_proj"
    z = F.linear(z, w[last + ".weight"], w[last + ".bias"])
    B, T, _ = z.shape
    return z.view(B, T, cfg["vq_groups"], cfg["vq_vars"])


def codes(w: Weights, cfg: dict, wav: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n_samples) -> ((B, frames, groups) int64 codes, the logits)."""
    lg = logits(w, cfg, wav)
    return lg.argmax(-1), lg
