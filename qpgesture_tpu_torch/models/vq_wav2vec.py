"""vq-wav2vec audio code extraction (inference path), as PyTorch modules.

The port of ``qpgesture_tpu/models/vq_wav2vec.py``, with fairseq's
parameter names, so that a vq-wav2vec checkpoint loads with
``load_state_dict`` (``load_vq_wav2vec_checkpoint``): a 4 s window (64000
samples) becomes (398, 2) int32 codes, the strings the Levenshtein matcher
(kernel K1) compares.

  * conv stack [(512,10,5), (512,8,4), (512,4,2), (512,4,2), (512,4,2)]:
    Conv1d(bias=False) -> GroupNorm(1 group, affine, eps 1e-5, over (C, T))
    -> exact GELU (or ReLU), optional skip connections, then log(1 + |x|);
  * GumbelVectorQuantizer at inference: a weight projection (a Linear, or
    an MLP when trained with weight_proj_depth > 1) to groups * num_vars
    logits, and the per-group argmax. The codes are the output contract, so
    the logits are true float32 (TF32 off, set when the package loads).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device


@dataclass(frozen=True)
class VQWav2VecConfig:
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 8, 4), (512, 4, 2), (512, 4, 2), (512, 4, 2))
    activation: str = "gelu"        # vq-wav2vec default
    log_compression: bool = True
    skip_connections: bool = False
    residual_scale: float = 0.5
    groups: int = 2
    num_vars: int = 320
    weight_proj_depth: int = 1
    weight_proj_factor: int = 2


def _act(name: str) -> nn.Module:
    return nn.GELU() if name == "gelu" else nn.ReLU()


class VQW2VFeatureExtractor(nn.Module):
    """(B, n_samples) -> (B, frames, C); 64000 samples -> 398 frames.
    Block i is fairseq's Sequential (conv, dropout, group norm, act)."""

    def __init__(self, cfg: VQWav2VecConfig):
        super().__init__()
        self.cfg = cfg
        blocks = []
        c_in = 1
        for dim, k, stride in cfg.conv_layers:
            blocks.append(nn.Sequential(
                nn.Conv1d(c_in, dim, k, stride=stride, bias=False),
                nn.Identity(), nn.GroupNorm(1, dim, eps=1e-5),
                _act(cfg.activation)))
            c_in = dim
        self.conv_layers = nn.ModuleList(blocks)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = wav[:, None, :]
        for block in self.conv_layers:
            residual = x
            x = block(x)
            if cfg.skip_connections and residual.shape[1] == x.shape[1]:
                t = x.shape[-1]
                r = residual[..., ::residual.shape[-1] // t][..., :t]
                x = (x + r) * cfg.residual_scale
        if cfg.log_compression:
            x = torch.log1p(x.abs())
        return x.transpose(1, 2)


class GumbelCodebook(nn.Module):
    """Inference path of fairseq's GumbelVectorQuantizer: logits argmax.
    The projection is ``weight_proj`` (a Linear at depth 1, else fairseq's
    Sequential of (Linear, act) blocks and a last Linear)."""

    def __init__(self, cfg: VQWav2VecConfig, in_dim: int):
        super().__init__()
        self.cfg = cfg
        out_dim = cfg.groups * cfg.num_vars
        if cfg.weight_proj_depth > 1:
            inner = cfg.weight_proj_factor * in_dim
            blocks, d_in = [], in_dim
            for _ in range(cfg.weight_proj_depth - 1):
                blocks.append(nn.Sequential(nn.Linear(d_in, inner),
                                            _act(cfg.activation)))
                d_in = inner
            self.weight_proj = nn.Sequential(*blocks,
                                             nn.Linear(inner, out_dim))
        else:
            self.weight_proj = nn.Linear(in_dim, out_dim)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B, T, groups) int32 codes (forward_idx)."""
        B, T, _ = z.shape
        logits = self.weight_proj(z).view(B, T, self.cfg.groups,
                                          self.cfg.num_vars)
        return logits.argmax(dim=-1).to(torch.int32)


class VQWav2Vec(nn.Module):
    def __init__(self, cfg: VQWav2VecConfig = VQWav2VecConfig(),
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.feature_extractor = VQW2VFeatureExtractor(cfg)
        self.vector_quantizer = GumbelCodebook(cfg, cfg.conv_layers[-1][0])
        self.eval().to(dev)

    @property
    def device(self) -> torch.device:
        return self.feature_extractor.conv_layers[0][0].weight.device

    @torch.no_grad()
    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, 64000) float32 -> (B, 398, 2) int32 codes, the wavvq_240.npz
        schema."""
        return self.vector_quantizer(self.feature_extractor(wav))


def _weight_proj_layout(state_dict: Dict) -> Tuple[int, Dict[str, str]]:
    """(depth, {checkpoint key: port key}) for fairseq's weight_proj
    layouts: a Linear (depth 1); nested blocks '.{d}.0' and a last Linear
    '.{depth-1}'; or a flat Sequential with Linears at even indices."""
    pre = "vector_quantizer.weight_proj."
    if pre + "weight" in state_dict:
        return 1, {}
    idx = sorted({int(k[len(pre):].split(".")[0]) for k in state_dict
                  if k.startswith(pre)})
    if pre + "0.0.weight" in state_dict:               # nested
        return len(idx), {}
    linears = [i for i in idx if pre + f"{i}.weight" in state_dict]
    depth = len(linears)
    rename = {}
    for d, i in enumerate(linears):
        dst = f"{d}.0" if d < depth - 1 else f"{depth - 1}"
        for p in ("weight", "bias"):
            rename[f"{pre}{i}.{p}"] = f"{pre}{dst}.{p}"
    return depth, rename


def load_vq_wav2vec_checkpoint(path: str,
                               device: DeviceLike = "cuda") -> VQWav2Vec:
    """Load a fairseq vq-wav2vec.pt checkpoint (state under 'model'). The
    weight_proj depth is read from the keys; keys the port does not hold
    (the codebook vectors, the aggregator) are ignored; a key the port needs
    and the checkpoint lacks raises."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    depth, rename = _weight_proj_layout(sd)
    sd = {rename.get(k, k): v for k, v in sd.items()}
    model = VQWav2Vec(VQWav2VecConfig(weight_proj_depth=max(depth, 1)),
                      device=device)
    wanted = model.state_dict().keys()
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {len(missing)} vq-wav2vec "
                       f"tensors, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in wanted})
    return model
