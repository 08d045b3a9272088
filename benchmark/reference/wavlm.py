"""WavLM (Chen et al., 2022, "WavLM: Large-Scale Self-Supervised
Pre-Training for Full Stack Speech Processing") in plain PyTorch: raw 16 kHz
wav -> the last layer's features, the inference path of Microsoft's
``WavLM.extract_features`` with ``layer_norm_first`` (WavLM-Large).

Weights are a dict of tensors under Microsoft's parameter names. The
numbers come from the configuration file (``widths``): layer-norm epsilon
included, which the file states as the program runs it.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def position_buckets(T: int, num_buckets: int, max_distance: int,
                     device) -> torch.Tensor:
    """(T, T) T5 bidirectional buckets of memory - context positions
    (WavLM's compute_bias)."""
    pos = torch.arange(T, device=device)
    rel = pos[None, :] - pos[:, None]
    nb = num_buckets // 2
    buckets = (rel > 0).long() * nb
    rel = rel.abs()
    max_exact = nb // 2
    large = max_exact + (torch.log(rel.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (nb - max_exact)).long()
    large = torch.clamp(large, max=nb - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


def _ln(x, w: Weights, name: str, eps: float):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"],
                        w[name + ".bias"], eps)


def _lin(x, w: Weights, name: str):
    return F.linear(x, w[name + ".weight"], w.get(name + ".bias"))


def features(w: Weights, cfg: dict, wav: torch.Tensor) -> torch.Tensor:
    """(B, n_samples) float32 wav -> (B, frames, hidden) float32."""
    eps = cfg["layer_norm_eps"]
    if cfg["normalize_wav"]:
        mean = wav.mean(-1, keepdim=True)
        var = wav.var(-1, unbiased=False, keepdim=True)
        wav = (wav - mean) / torch.sqrt(var + cfg["wav_norm_eps"])
    h = wav[:, None, :]
    for i, (dim, k, s) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"],
                                        cfg["conv_stride"])):
        pre = f"feature_extractor.conv_layers.{i}"
        h = F.conv1d(h, w[pre + ".0.weight"], w.get(pre + ".0.bias"),
                     stride=s)
        h = F.gelu(_ln(h.transpose(1, 2), w, pre + ".2.1", eps)
                   ).transpose(1, 2)
    x = _ln(h.transpose(1, 2), w, "layer_norm", eps)
    x = _lin(x, w, "post_extract_proj")

    # convolutional relative position embedding under weight norm (dim 2)
    v = w["encoder.pos_conv.0.weight_v"]
    g = w["encoder.pos_conv.0.weight_g"]
    kernel = g * v / v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    k = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(x.transpose(1, 2), kernel, w["encoder.pos_conv.0.bias"],
                   padding=k // 2, groups=cfg["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[..., :-1]
    x = x + F.gelu(pos).transpose(1, 2)

    B, T, D = x.shape
    H = cfg["num_attention_heads"]
    hd = D // H
    buckets = position_buckets(T, cfg["num_buckets"],
                               cfg["max_bucket_distance"], x.device)
    bias = w["encoder.layers.0.self_attn.relative_attention_bias.weight"][
        buckets].permute(2, 0, 1)                            # (H, T, T)
    for layer in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{layer}"
        y = _ln(x, w, pre + ".self_attn_layer_norm", eps)
        q = _lin(y, w, pre + ".self_attn.q_proj").view(B, T, H, hd)
        kk = _lin(y, w, pre + ".self_attn.k_proj").view(B, T, H, hd)
        vv = _lin(y, w, pre + ".self_attn.v_proj").view(B, T, H, hd)
        # gated relative position bias, from the layer's input split into
        # heads
        g = _lin(y.view(B, T, H, hd).transpose(1, 2), w,
                 pre + ".self_attn.grep_linear")             # (B, H, T, 8)
        g = torch.sigmoid(g.view(B, H, T, 2, 4).sum(-1))
        gate_a, gate_b = g[..., 0], g[..., 1]
        gate = gate_a * (gate_b * w[pre + ".self_attn.grep_a"][..., 0]
                         - 1.0) + 2.0                        # (B, H, T)
        scores = torch.einsum("bthd,bshd->bhts", q * hd ** -0.5, kk)
        scores = scores + gate[..., None] * bias[None]
        attn = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhts,bshd->bthd", attn, vv).reshape(B, T, D)
        x = x + _lin(out, w, pre + ".self_attn.out_proj")
        y = _ln(x, w, pre + ".final_layer_norm", eps)
        x = x + _lin(F.gelu(_lin(y, w, pre + ".fc1")), w, pre + ".fc2")
    return _ln(x, w, "encoder.layer_norm", eps)
