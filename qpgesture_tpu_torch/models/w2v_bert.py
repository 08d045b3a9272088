"""w2v-BERT 2.0 encoder (inference path), as PyTorch modules.

The speech encoder of SeamlessM4T v2 (https://huggingface.co/facebook/
w2v-bert-2.0), a 24-layer Conformer over Kaldi filter banks, with the
parameter names of ``transformers``' ``Wav2Vec2BertModel``, so that a
published checkpoint loads with ``load_state_dict``
(``load_w2v_bert_checkpoint``). The JAX package has no counterpart: the
port holds it against ``transformers`` and the benchmark's plain reference
(``tests/test_torch_w2v_bert.py``).

Raw 16 kHz windows in, the last layer's hidden states out:

  * ``ops/fbank.py``: Kaldi log-mel filter banks, normalised per window,
    frame pairs stacked: (B, 199, 160) for 4 s windows;
  * the feature projection: LayerNorm(160) and Linear(160 -> D);
  * 24 pre-LN Conformer layers (``Wav2Vec2BertEncoderLayer``):
      x = x + 0.5 FFN1(LN(x))            FFN: Linear, swish, Linear
      x = x + Wo MHSA(LN(x))             relative-key attention, K4
      x = x + ConvModule(x)              LN, pointwise 1024 -> 2048, GLU,
                                         causal depthwise k=31, LN, swish,
                                         pointwise 1024 -> 1024
      x = x + 0.5 FFN2(LN(x))
      x = LN(x)
  * no positional convolution, no LayerNorm after the stack, no adapter;
    windows are never padded, so there is no mask.

Every LayerNorm uses the published epsilon 1e-5. Contractions are float32
with TF32 off (the package's setting; the features feed cosine ranks).
Channels stay last: the pointwise convolutions are linear layers on
(B, T, C) with the conv weights' (out, in, 1) viewed as (out, in); only
the depthwise convolution runs on a (B, C, T) view. Attention goes through
kernel K4 (``ops/relkey_attention_cuda.py``) on the card and its plain
version on the CPU.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops import relkey_attention_cuda
from ..ops.fbank import FEATURE_DIM, fbank
from ..utils.profiling import count, span


@dataclass(frozen=True)
class W2VBertConfig:
    """``Wav2Vec2BertConfig``'s defaults (w2v-BERT 2.0's widths)."""
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    conv_depthwise_kernel_size: int = 31
    layer_norm_eps: float = 1e-5


class FeedForward(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.silu(self.intermediate_dense(x)))


class SelfAttention(nn.Module):
    """Multi-head attention with relative-key distance embeddings."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        D, H = cfg.hidden_size, cfg.num_attention_heads
        self.heads, self.head_size = H, D // H
        self.left = cfg.left_max_position_embeddings
        self.right = cfg.right_max_position_embeddings
        self.linear_q = nn.Linear(D, D)
        self.linear_k = nn.Linear(D, D)
        self.linear_v = nn.Linear(D, D)
        self.linear_out = nn.Linear(D, D)
        self.distance_embedding = nn.Embedding(self.left + self.right + 1,
                                               self.head_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        shape = (B, T, self.heads, self.head_size)
        q, k, v = (lin(x).view(shape).transpose(1, 2)
                   for lin in (self.linear_q, self.linear_k, self.linear_v))
        out = relkey_attention_cuda.relkey_attention(
            q, k, v, self.distance_embedding.weight, left=self.left,
            right=self.right, sm_scale=1.0 / math.sqrt(self.head_size))
        return self.linear_out(out.transpose(1, 2).reshape(B, T, D))


class ConvolutionModule(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        D, k = cfg.hidden_size, cfg.conv_depthwise_kernel_size
        self.layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.pointwise_conv1 = nn.Conv1d(D, 2 * D, 1, bias=False)
        self.depthwise_conv = nn.Conv1d(D, D, k, groups=D, bias=False)
        self.depthwise_layer_norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.pointwise_conv2 = nn.Conv1d(D, D, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(self.layer_norm(x), self.pointwise_conv1.weight[..., 0])
        y = F.glu(y, dim=-1)                                  # (B, T, D)
        w = self.depthwise_conv.weight
        y = F.conv1d(F.pad(y.transpose(1, 2), (w.shape[-1] - 1, 0)), w,
                     groups=w.shape[0]).transpose(1, 2)       # causal
        y = F.silu(self.depthwise_layer_norm(y))
        return F.linear(y, self.pointwise_conv2.weight[..., 0])


class ConformerLayer(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        D, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ffn1_layer_norm = nn.LayerNorm(D, eps=eps)
        self.ffn1 = FeedForward(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(D, eps=eps)
        self.self_attn = SelfAttention(cfg)
        self.conv_module = ConvolutionModule(cfg)
        self.ffn2_layer_norm = nn.LayerNorm(D, eps=eps)
        self.ffn2 = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(D, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ffn1(self.ffn1_layer_norm(x)) * 0.5 + x
        x = self.self_attn(self.self_attn_layer_norm(x)) + x
        x = x + self.conv_module(x)
        x = self.ffn2(self.ffn2_layer_norm(x)) * 0.5 + x
        return self.final_layer_norm(x)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.feature_projection_input_dim,
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.feature_projection_input_dim,
                                    cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class Encoder(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.layers = nn.ModuleList(ConformerLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))


class W2VBert(nn.Module):
    """Raw 16 kHz wav -> ``last_hidden_state`` of w2v-BERT 2.0: (B, 199,
    D) float32 for 4 s windows, the 50 Hz features the wavlm audio modes
    stage (``RawWavServer`` takes it as its encoder)."""

    def __init__(self, cfg: W2VBertConfig = W2VBertConfig(),
                 device: DeviceLike = "cuda"):
        super().__init__()
        if cfg.feature_projection_input_dim != FEATURE_DIM:
            raise ValueError(
                f"feature_projection_input_dim "
                f"{cfg.feature_projection_input_dim} is not the front end's "
                f"{FEATURE_DIM}")
        self.cfg = cfg
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)
        self.eval().to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.feature_projection.projection.weight.device

    @torch.no_grad()
    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, n_samples) float wav at +-1 -> (B, frames, D) float32."""
        with span("fbank"):
            feats = fbank(wav)
            count("frames", feats.shape[1])
        with span("conformer"):
            x = self.feature_projection(feats)
            before = relkey_attention_cuda.launches
            for layer in self.encoder.layers:
                x = layer(x)
            count("layers", len(self.encoder.layers))
            if relkey_attention_cuda.launches != before:
                count("relkey_kernel", 1)
        return x


def w2v_bert_config_from_hf(raw: dict) -> W2VBertConfig:
    """The fields of a ``Wav2Vec2BertConfig`` (its ``config.json``) that
    the port reads; a checkpoint the port cannot run is refused."""
    if raw.get("position_embeddings_type", "relative_key") != "relative_key":
        raise ValueError(f"the port runs relative_key attention, the "
                         f"checkpoint states "
                         f"{raw['position_embeddings_type']!r}")
    if raw.get("add_adapter") or \
            raw.get("use_intermediate_ffn_before_adapter"):
        raise ValueError("the port runs w2v-BERT without its adapter")
    if raw.get("hidden_act", "swish") not in ("swish", "silu"):
        raise ValueError(f"the port runs swish, the checkpoint states "
                         f"{raw['hidden_act']!r}")
    d = W2VBertConfig()
    return W2VBertConfig(**{f: raw.get(f, getattr(d, f))
                            for f in d.__dataclass_fields__})


def _read_state_dict(path: str) -> dict:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_w2v_bert_checkpoint(path: str, device: DeviceLike = "cuda"
                             ) -> W2VBert:
    """Load a published w2v-BERT 2.0: a directory in ``transformers``'
    layout (``config.json`` and ``model.safetensors`` or
    ``pytorch_model.bin``), or one ``Wav2Vec2BertModel`` state-dict file
    at the published widths. Keys the port does not hold
    (``masked_spec_embed``) are ignored; a key the port needs and the
    checkpoint lacks raises."""
    cfg = W2VBertConfig()
    if os.path.isdir(path):
        with open(os.path.join(path, "config.json")) as f:
            cfg = w2v_bert_config_from_hf(json.load(f))
        for name in ("model.safetensors", "pytorch_model.bin"):
            if os.path.exists(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
        else:
            raise FileNotFoundError(f"{path} holds neither model.safetensors "
                                    f"nor pytorch_model.bin")
    sd = _read_state_dict(path)
    model = W2VBert(cfg, device=device)
    wanted = model.state_dict().keys()
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {len(missing)} w2v-BERT "
                       f"tensors, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in wanted})
    return model
