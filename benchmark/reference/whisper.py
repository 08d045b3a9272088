"""Whisper-large-v3's encoder (Radford et al., 2022, "Robust Speech Recognition
via Large-Scale Weak Supervision") in plain PyTorch: raw 16 kHz wav ->
``last_hidden_state`` of ``transformers``' ``WhisperEncoder`` after its
``WhisperFeatureExtractor``, cut back to the windows.

One call is one utterance: the windows it is handed (a clip, at most 7 of
4 s) are joined, zero-padded to 30 s and encoded together; window ``w``'s
features are positions ``[200 w, 200 w + 200)``. A block of more windows
than 30 s holds is refused.

Weights are a dict of tensors under ``WhisperEncoder``'s parameter names.
The numbers come from the configuration file: the widths, the LayerNorm
epsilon and the feature extractor's settings (``feature_extractor``).
Float32 with TF32 off; attention is the materialised softmax, taken in
blocks of query rows so that the (heads, 1500, 1500) logits never exist
at once.

Departures: none in the mathematics; the mel bank is built here in
float64 (librosa's formulation of Slaney's bank) and used in float32, as
the extractor's torch path uses its own.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
QUERY_BLOCK = 256          # query rows of one block of attention logits


def _slaney_mel(hz):
    hz = np.atleast_1d(np.asarray(hz, np.float64))
    mel = hz / (200.0 / 3.0)
    log = hz >= 1000.0
    mel[log] = 15.0 + np.log(hz[log] / 1000.0) / (np.log(6.4) / 27.0)
    return mel


def _slaney_hz(mel):
    mel = np.asarray(mel, np.float64)
    hz = mel * (200.0 / 3.0)
    log = mel >= 15.0
    hz[log] = 1000.0 * np.exp((np.log(6.4) / 27.0) * (mel[log] - 15.0))
    return hz


def mel_weights(fe: dict) -> torch.Tensor:
    """(mels, n_fft // 2 + 1) float64 Slaney triangles with Slaney's area
    normalisation, between f_min and f_max."""
    n_bins = fe["n_fft"] // 2 + 1
    fft_hz = np.linspace(0.0, fe["sampling_rate"] / 2, n_bins)
    edges = _slaney_hz(np.linspace(_slaney_mel(fe["f_min"])[0],
                                   _slaney_mel(fe["f_max"])[0],
                                   fe["feature_size"] + 2))
    gaps = np.diff(edges)
    ramps = edges[:, None] - fft_hz[None, :]
    out = np.zeros((fe["feature_size"], n_bins))
    for i in range(fe["feature_size"]):
        lower = -ramps[i] / gaps[i]
        upper = ramps[i + 2] / gaps[i + 1]
        out[i] = np.maximum(0.0, np.minimum(lower, upper))
    out *= (2.0 / (edges[2:] - edges[:-2]))[:, None]
    return torch.from_numpy(out)


def log_mel(fe: dict, audio: torch.Tensor) -> torch.Tensor:
    """(U, samples) float32 audio at +-1, padded to 30 s -> (U, mels,
    frames) Whisper log-mel features, each utterance clamped to its own
    maximum less the dynamic range."""
    n_fft = fe["n_fft"]
    window = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(
        n_fft, dtype=torch.float64) / n_fft)          # periodic Hann
    spec = torch.stft(audio, n_fft, fe["hop_length"],
                      window=window.float().to(audio.device), center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec[..., :fe["nb_max_frames"]].abs() ** 2
    mel = mel_weights(fe).float().to(audio.device) @ power
    log = torch.log10(torch.clamp(mel, min=fe["log_floor"]))
    top = log.flatten(1).max(dim=1).values[:, None, None]
    log = torch.maximum(log, top - fe["dynamic_range"])
    return (log + 4.0) / 4.0


def _ln(x, w: Weights, name: str, eps: float):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"],
                        w[name + ".bias"], eps)


def _lin(x, w: Weights, name: str):
    return F.linear(x, w[name + ".weight"], w.get(name + ".bias"))


def attention(q, k, v):
    """softmax(q k^T / sqrt(hd)) v over (B, H, T, hd), QUERY_BLOCK query
    rows of logits at a time."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.cat([
        torch.softmax(q[:, :, s:s + QUERY_BLOCK] @ k.transpose(-1, -2)
                      * scale, dim=-1) @ v
        for s in range(0, q.shape[2], QUERY_BLOCK)], dim=2)


def features(w: Weights, cfg: dict, wav: torch.Tensor) -> torch.Tensor:
    """(n, samples) float32 windows of one utterance -> (n, samples / 320,
    d_model) float32."""
    fe = cfg["feature_extractor"]
    n, samples = wav.shape
    if n * samples > fe["n_samples"]:
        raise ValueError(f"{n} windows of {samples} samples are more than "
                         f"one {fe['chunk_length']} s utterance")
    audio = F.pad(wav.reshape(1, n * samples),
                  (0, fe["n_samples"] - n * samples),
                  value=fe["padding_value"])
    x = F.gelu(F.conv1d(log_mel(fe, audio), w["conv1.weight"],
                        w["conv1.bias"], padding=1))
    x = F.gelu(F.conv1d(x, w["conv2.weight"], w["conv2.bias"], stride=2,
                        padding=1))
    x = x.transpose(1, 2) + w["embed_positions.weight"]
    B, T, D = x.shape
    H = cfg["encoder_attention_heads"]
    eps = cfg["layer_norm_eps"]
    for layer in range(cfg["encoder_layers"]):
        pre = f"layers.{layer}"
        y = _ln(x, w, pre + ".self_attn_layer_norm", eps)
        q, k, v = (_lin(y, w, f"{pre}.self_attn.{p}_proj")
                   .view(B, T, H, D // H).transpose(1, 2) for p in "qkv")
        a = attention(q, k, v).transpose(1, 2).reshape(B, T, D)
        x = x + _lin(a, w, pre + ".self_attn.out_proj")
        y = _ln(x, w, pre + ".final_layer_norm", eps)
        x = x + _lin(F.gelu(_lin(y, w, pre + ".fc1")), w, pre + ".fc2")
    x = _ln(x, w, "layer_norm", eps)
    per = samples // (2 * fe["hop_length"])
    return x[0, :n * per].reshape(n, per, D)
