"""Carry VQ-VAE weights between the JAX parameter trees and the port.

The port's VQVAE uses the reference's parameter names, so a reference
checkpoint loads with ``load_state_dict`` (``load_vqvae_checkpoint``).
``vqvae_state_dict_from_jax`` is the exact inverse of the JAX package's
``models/torch_convert.convert_vqvae``: it maps a flax parameter tree and
codebook back to a state_dict.

Layout facts (the inverse of those in torch_convert):
  * flax conv kernel (k, in, out) -> Conv1d weight (out, in, k);
  * the JAX ConvTranspose1dTorch kernel (k, in, out) is stored flipped
    along k -> ConvTranspose1d weight (in, out, k) after un-flipping;
  * the codebook k -> bottleneck.level_blocks.0.k.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.config import VQVAEConfig
from ..device import DeviceLike
from .vqvae import VQVAE


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _conv1d(p: Dict, key: str, out: Dict) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    out[f"{key}.bias"] = _t(p["bias"])


def _conv_transpose1d(p: Dict, key: str, out: Dict) -> None:
    kernel = np.asarray(p["kernel"])[::-1]            # un-flip along k
    out[f"{key}.weight"] = _t(kernel.transpose(1, 2, 0))
    out[f"{key}.bias"] = _t(p["bias"])


def _resnet(p: Dict, key: str, depth: int, out: Dict) -> None:
    for d in range(depth):
        _conv1d(p[f"block{d}"]["conv1"], f"{key}.model.{d}.model.1", out)
        _conv1d(p[f"block{d}"]["conv2"], f"{key}.model.{d}.model.3", out)


def vqvae_state_dict_from_jax(params: Dict, cb,
                              cfg: VQVAEConfig) -> Dict[str, torch.Tensor]:
    """(flax params, codebook with a ``k`` field) -> the port's (and the
    reference's) VQVAE state_dict, as CPU float32 tensors."""
    down_t = cfg.downs_t[0]
    depth = cfg.depth * cfg.hvqvae_multipliers[0]
    sd: Dict[str, torch.Tensor] = {}

    enc = params["encoder"]["level0"]
    enc_base = "encoders.0.level_blocks.0"
    for i in range(down_t):
        _conv1d(enc[f"down{i}_conv"], f"{enc_base}.model.{i}.0", sd)
        _resnet(enc[f"down{i}_resnet"], f"{enc_base}.model.{i}.1", depth, sd)
    _conv1d(enc["proj"], f"{enc_base}.model.{down_t}", sd)

    dec = params["decoder"]["level0"]
    dec_base = "decoders.0.level_blocks.0"
    _conv1d(dec["proj"], f"{dec_base}.model.0", sd)
    for i in range(down_t):
        _resnet(dec[f"up{i}_resnet"], f"{dec_base}.model.{i + 1}.0", depth,
                sd)
        _conv_transpose1d(dec[f"up{i}_convt"], f"{dec_base}.model.{i + 1}.1",
                          sd)
    _conv1d(params["decoder"]["out"], "decoders.0.out", sd)

    sd["bottleneck.level_blocks.0.k"] = _t(cb.k)
    return sd


def strip_prefix(state_dict: Dict, prefix: str = "module.") -> Dict:
    """Remove nn.DataParallel's 'module.' wrapper prefix."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in state_dict.items()}


def _torch_load_reference(path: str):
    """torch.load for reference checkpoints, tolerant of the pickled
    EasyDict config: the reference saves {'args': EasyDict, 'epoch',
    'model_dict'} (train.py:114-116), and unpickling the args needs the
    easydict package, so an equivalent shim module stands in when it is
    missing."""
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except ModuleNotFoundError as e:
        if "easydict" not in str(e):
            raise
        import sys
        import types

        class EasyDict(dict):
            def __getattr__(self, k):
                try:
                    return self[k]
                except KeyError:
                    raise AttributeError(k)

            def __setattr__(self, k, v):
                self[k] = v

        mod = types.ModuleType("easydict")
        mod.EasyDict = EasyDict
        sys.modules["easydict"] = mod
        try:
            return torch.load(path, map_location="cpu", weights_only=False)
        finally:
            sys.modules.pop("easydict", None)


def load_vqvae_checkpoint(path: str, cfg: VQVAEConfig,
                          device: DeviceLike = "cuda") -> VQVAE:
    """Load a reference .bin/.pt checkpoint into a port VQVAE. Keys the port
    does not hold (the reference's EMA statistics buffers) are ignored; a
    key the port needs and the checkpoint lacks raises."""
    ckpt = _torch_load_reference(path)
    sd = strip_prefix(ckpt["model_dict"] if "model_dict" in ckpt else ckpt)
    model = VQVAE(cfg, device=device)
    wanted = model.state_dict().keys()
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {len(missing)} VQ-VAE "
                       f"tensors, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in wanted})
    return model
