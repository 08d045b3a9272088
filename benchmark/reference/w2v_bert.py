"""w2v-BERT 2.0 (the speech encoder of SeamlessM4T v2; Barrault et al.,
2023, "Seamless: Multilingual Expressive and Streaming Speech Translation")
in plain PyTorch: raw 16 kHz wav -> ``last_hidden_state``, the inference
path of ``transformers``' ``Wav2Vec2BertModel`` after its
``SeamlessM4TFeatureExtractor``, each window its own utterance.

Weights are a dict of tensors under ``Wav2Vec2BertModel``'s parameter
names. The numbers come from the configuration file: the widths, the
relative range, the depthwise kernel, the LayerNorm epsilon and the
filter-bank settings (``fbank``).

Departures: the filter bank runs in float32 where the extractor runs in
float64 and rounds its output to float32 (the features agree to ~2e-4 of
their unit scale); no padding, mask or adapter, as the configuration
states.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def _mel(f):
    return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)


def mel_triangles(fb: dict) -> torch.Tensor:
    """(fft // 2 + 1, mels) float64: triangles in Kaldi-mel space with
    unit peaks, between ``low_hz`` and half the sample rate."""
    n_bins = fb["fft_length"] // 2 + 1
    centres = np.linspace(_mel(fb["low_hz"]), _mel(fb["sample_rate"] / 2),
                          fb["mel_bins"] + 2)
    m = _mel(np.arange(n_bins) * fb["sample_rate"] / fb["fft_length"])
    out = np.zeros((n_bins, fb["mel_bins"]))
    for i in range(fb["mel_bins"]):
        lo, mid, hi = centres[i], centres[i + 1], centres[i + 2]
        up = (m - lo) / (mid - lo)
        down = (hi - m) / (hi - mid)
        out[:, i] = np.clip(np.minimum(up, down), 0.0, None)
    return torch.from_numpy(out)


def fbank(fb: dict, wav: torch.Tensor) -> torch.Tensor:
    """(n, samples) float32 wav at +-1 -> (n, frames // stride, mels x
    stride) normalised log-mel features."""
    L, hop, n_fft = fb["frame_length"], fb["hop_length"], fb["fft_length"]
    n_frames = (wav.shape[1] - L) // hop + 1
    idx = (torch.arange(n_frames, device=wav.device)[:, None] * hop
           + torch.arange(L, device=wav.device)[None, :])
    frames = (wav * 32768.0)[:, idx]                        # (n, F, L)
    frames = frames - frames.mean(dim=2, keepdim=True)
    shifted = F.pad(frames, (1, 0))[..., :L]
    shifted[..., 0] = frames[..., 0]
    frames = frames - fb["preemphasis"] * shifted
    hann = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(
        L, dtype=torch.float64) / (L - 1))
    window = hann.pow(fb["window_power"]).float().to(wav.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    power = spec.abs().pow(2)
    mel = torch.matmul(power, mel_triangles(fb).float().to(wav.device))
    logmel = torch.log(torch.maximum(
        mel, torch.tensor(fb["mel_floor"], device=wav.device)))
    centred = logmel - logmel.mean(dim=1, keepdim=True)
    var = centred.pow(2).sum(dim=1, keepdim=True) / (n_frames - 1)
    feats = centred / torch.sqrt(var + fb["norm_eps"])
    s = fb["stride"]
    keep = n_frames // s * s
    return feats[:, :keep].reshape(wav.shape[0], keep // s, -1)


def _ln(x, w: Weights, name: str, eps: float):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"],
                        w[name + ".bias"], eps)


def _lin(x, w: Weights, name: str):
    return F.linear(x, w[name + ".weight"], w.get(name + ".bias"))


def _ffn(x, w: Weights, name: str):
    return _lin(F.silu(_lin(x, w, name + ".intermediate_dense")), w,
                name + ".output_dense")


def features(w: Weights, cfg: dict, wav: torch.Tensor) -> torch.Tensor:
    """(B, n_samples) float32 wav -> (B, frames, hidden) float32."""
    eps = cfg["layer_norm_eps"]
    x = _ln(fbank(cfg["fbank"], wav), w, "feature_projection.layer_norm",
            eps)
    x = _lin(x, w, "feature_projection.projection")
    B, T, D = x.shape
    H = cfg["num_attention_heads"]
    hd = D // H
    left = cfg["left_max_position_embeddings"]
    right = cfg["right_max_position_embeddings"]
    pos = torch.arange(T, device=x.device)
    dist = torch.clamp(pos[None, :] - pos[:, None], -left, right) + left
    for layer in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{layer}"
        x = x + 0.5 * _ffn(_ln(x, w, pre + ".ffn1_layer_norm", eps), w,
                           pre + ".ffn1")

        y = _ln(x, w, pre + ".self_attn_layer_norm", eps)
        q = _lin(y, w, pre + ".self_attn.linear_q").view(B, T, H, hd)
        k = _lin(y, w, pre + ".self_attn.linear_k").view(B, T, H, hd)
        v = _lin(y, w, pre + ".self_attn.linear_v").view(B, T, H, hd)
        rel = w[pre + ".self_attn.distance_embedding.weight"][dist]  # T T hd
        scores = (torch.einsum("bihd,bjhd->bhij", q, k)
                  + torch.einsum("bihd,ijd->bhij", q, rel)) / math.sqrt(hd)
        attn = torch.einsum("bhij,bjhd->bihd", torch.softmax(scores, -1), v)
        x = x + _lin(attn.reshape(B, T, D), w, pre + ".self_attn.linear_out")

        c = pre + ".conv_module"
        y = _ln(x, w, c + ".layer_norm", eps).transpose(1, 2)   # (B, D, T)
        y = F.glu(F.conv1d(y, w[c + ".pointwise_conv1.weight"]), dim=1)
        kw = w[c + ".depthwise_conv.weight"]
        y = F.conv1d(F.pad(y, (kw.shape[-1] - 1, 0)), kw, groups=D)
        y = F.silu(_ln(y.transpose(1, 2), w, c + ".depthwise_layer_norm",
                       eps)).transpose(1, 2)
        y = F.conv1d(y, w[c + ".pointwise_conv2.weight"]).transpose(1, 2)
        x = x + y

        x = x + 0.5 * _ffn(_ln(x, w, pre + ".ffn2_layer_norm", eps), w,
                           pre + ".ffn2")
        x = _ln(x, w, pre + ".final_layer_norm", eps)
    return x
