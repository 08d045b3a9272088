"""Whisper-large-v3's audio encoder (inference path), as PyTorch modules.

The encoder of OpenAI's Whisper large-v3 (Radford et al., 2022, "Robust
Speech Recognition via Large-Scale Weak Supervision";
https://huggingface.co/openai/whisper-large-v3), with the parameter names
of ``transformers``' ``WhisperEncoder``, so that a published checkpoint
loads with ``load_state_dict`` (``load_whisper_checkpoint``). The JAX
package has no counterpart: the port holds it against ``transformers`` and
the benchmark's plain reference (``tests/test_torch_whisper.py``).

Whisper's input is one 30 s utterance, and QPGesture's clip is one: the
windows of a clip (at most 7 of 4 s) are joined, padded to 30 s and
encoded together, and window ``w`` gets encoder positions ``[200 w, 200 w
+ 200)``. So the encoder is told how its windows group into clips
(``forward(wav, clips)``; ``RawWavServer`` passes it, as
``takes_utterances`` asks):

  * ``ops/logmel.py``: Whisper's log-mel, (C, 128, 3000), the maximum
    taken per utterance;
  * the conv stem: Conv1d(128 -> D, 3, pad 1) + GELU, Conv1d(D -> D, 3,
    stride 2, pad 1) + GELU: 1500 positions;
  * the positional table (sinusoids in the published checkpoint) added;
  * 32 pre-LN layers:
      x = x + out_proj(MHSA(LN(x)))   q, v, out with a bias, k without;
                                      plain softmax attention over all
                                      1500 positions, kernel K2 bias-free
      x = x + fc2(GELU(fc1(LN(x))))
  * the final LayerNorm; each clip's first W x 200 positions, as (C W,
    200, D).

The 30 s padding is computed in full, as published: the encoder attends
over it, so it is part of every window's features. Every LayerNorm uses
the published epsilon 1e-5, GELU is exact. Contractions are float32 with
TF32 off (the package's setting; the features feed cosine ranks).
Attention goes through kernel K2's bias-free float32 instantiation
(``ops/flash_attention_cuda.py``) on the card and its plain version on the
CPU.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops import flash_attention_cuda
from ..ops.logmel import HOP_LENGTH, N_FRAMES, N_SAMPLES, SAMPLE_RATE, logmel
from ..utils.profiling import count, span

STEM_STRIDE = 2               # the second conv's stride: 2 mel frames a position


@dataclass(frozen=True)
class WhisperConfig:
    """The encoder's fields of large-v3's ``WhisperConfig``."""
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    num_mel_bins: int = 128
    max_source_positions: int = 1500
    layer_norm_eps: float = 1e-5


def sinusoids(length: int, channels: int,
              max_timescale: float = 10000.0) -> torch.Tensor:
    """Whisper's fixed positional table: (length, channels), sines then
    cosines of geometrically spaced timescales."""
    step = math.log(max_timescale) / (channels // 2 - 1)
    inv = torch.exp(-step * torch.arange(channels // 2, dtype=torch.float32))
    t = torch.arange(length, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([t.sin(), t.cos()], dim=1)


def positions_per_window(n_samples: int) -> int:
    """Encoder positions a window of n_samples covers (200 for 4 s)."""
    per = HOP_LENGTH * STEM_STRIDE
    if n_samples % per:
        raise ValueError(f"a window of {n_samples} samples does not end on "
                         f"an encoder position ({per} samples each)")
    return n_samples // per


class WhisperAttention(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        D, H = cfg.d_model, cfg.encoder_attention_heads
        self.heads, self.head_dim = H, D // H
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D, bias=False)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        shape = (B, T, self.heads, self.head_dim)
        q, k, v = (lin(x).view(shape).transpose(1, 2)
                   for lin in (self.q_proj, self.k_proj, self.v_proj))
        out = flash_attention_cuda.gated_flash_attention(
            q, k, v, None, sm_scale=self.head_dim ** -0.5)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))


class WhisperEncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        D, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = WhisperAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(D, eps=eps)
        self.fc1 = nn.Linear(D, cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, D)
        self.final_layer_norm = nn.LayerNorm(D, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class WhisperEncoder(nn.Module):
    """Raw 16 kHz windows and their clip layout -> the last hidden state,
    cut back to the windows: (C W, 200, D) float32 for C clips of W 4 s
    windows, the 50 Hz features the wavlm audio modes stage
    (``RawWavServer`` takes it as its encoder)."""

    takes_utterances = True    # RawWavServer passes the clip layout

    def __init__(self, cfg: WhisperConfig = WhisperConfig(),
                 device: DeviceLike = "cuda"):
        super().__init__()
        if cfg.max_source_positions * STEM_STRIDE != N_FRAMES:
            raise ValueError(f"max_source_positions "
                             f"{cfg.max_source_positions} is not the 30 s "
                             f"log-mel's {N_FRAMES} frames / {STEM_STRIDE}")
        self.cfg = cfg
        D = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, D, 3, padding=1)
        self.conv2 = nn.Conv1d(D, D, 3, stride=STEM_STRIDE, padding=1)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, D)
        with torch.no_grad():
            self.embed_positions.weight.copy_(
                sinusoids(cfg.max_source_positions, D))
        self.layers = nn.ModuleList(WhisperEncoderLayer(cfg)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.eval().to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.conv1.weight.device

    @torch.no_grad()
    def forward(self, wav: torch.Tensor,
                clips: Optional[int] = None) -> torch.Tensor:
        """(C W, n_samples) float wav at +-1, clip-major, as C clips of W
        windows (``clips`` None: each window its own utterance) -> (C W,
        n_samples / 320, D) float32 features in window order."""
        N, n = wav.shape
        C = N if clips is None else clips
        if C <= 0 or N % C:
            raise ValueError(f"{N} windows do not split into {C} clips")
        W, per = N // C, positions_per_window(n)
        if W * n > N_SAMPLES:
            raise ValueError(
                f"a clip of {W} windows of {n} samples is "
                f"{W * n / SAMPLE_RATE:g} s, past Whisper's "
                f"{N_SAMPLES // SAMPLE_RATE} s context: at most "
                f"{N_SAMPLES // n} such windows a clip")
        with span("logmel"):
            mel = logmel(wav.reshape(C, W * n), self.cfg.num_mel_bins)
            count("mel_frames", mel.shape[-1])
        with span("whisper"):
            x = F.gelu(self.conv2(F.gelu(self.conv1(mel))))
            x = x.transpose(1, 2) + self.embed_positions.weight
            before = flash_attention_cuda.nobias_launches
            for layer in self.layers:
                x = layer(x)
            x = self.layer_norm(x)
            count("layers", len(self.layers))
            count("utterances", C)
            if flash_attention_cuda.nobias_launches != before:
                count("attn_kernel", 1)
        return x[:, :W * per].reshape(N, per, -1)


def whisper_config_from_hf(raw: dict) -> WhisperConfig:
    """The encoder's fields of a ``WhisperConfig`` (its ``config.json``);
    a checkpoint the port cannot run is refused."""
    act = raw.get("activation_function", "gelu")
    if act != "gelu":
        raise ValueError(f"the port runs Whisper's exact GELU, the "
                         f"checkpoint states {act!r}")
    d = WhisperConfig()
    return WhisperConfig(**{f: raw.get(f, getattr(d, f))
                            for f in d.__dataclass_fields__})


def _read_state_dict(path: str) -> dict:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_whisper_checkpoint(path: str, device: DeviceLike = "cuda"
                            ) -> WhisperEncoder:
    """Load Whisper's encoder: a directory in ``transformers``' layout
    (``config.json`` and ``model.safetensors`` or ``pytorch_model.bin``) of
    a ``WhisperModel`` or ``WhisperForConditionalGeneration``, or one such
    state-dict file at large-v3's widths. The encoder's tensors are read
    under ``encoder.*`` or ``model.encoder.*`` (the decoder's are not
    read); a tensor the encoder needs and the checkpoint lacks raises."""
    cfg = WhisperConfig()
    if os.path.isdir(path):
        with open(os.path.join(path, "config.json")) as f:
            cfg = whisper_config_from_hf(json.load(f))
        for name in ("model.safetensors", "pytorch_model.bin"):
            if os.path.exists(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
        else:
            raise FileNotFoundError(f"{path} holds neither model.safetensors "
                                    f"nor pytorch_model.bin")
    sd = _read_state_dict(path)
    prefix = next((p for p in ("model.encoder.", "encoder.")
                   if any(k.startswith(p) for k in sd)), "")
    model = WhisperEncoder(cfg, device=device)
    wanted = model.state_dict().keys()
    missing = [k for k in wanted if prefix + k not in sd]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {len(missing)} Whisper "
                       f"encoder tensors, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[prefix + k] for k in wanted})
    return model
