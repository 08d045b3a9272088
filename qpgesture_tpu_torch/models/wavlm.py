"""WavLM encoder (inference path), as PyTorch modules.

The port of ``qpgesture_tpu/models/wavlm.py``: the same graph, with the
parameter names of Microsoft's WavLM state dict, so that a published
checkpoint loads with ``load_state_dict`` (``load_wavlm_checkpoint``).

  * ConvFeatureExtractor: 7 strided Conv1d layers
    [(512,10,5), (512,3,2)x4, (512,2,2)x2]; 'default' mode group-norms the
    first block, 'layer_norm' mode layer-norms every block; exact GELU;
  * feature LayerNorm + Linear projection to the encoder width;
  * the encoder: weight-normed grouped conv positional embedding (k=128,
    groups=16, SamePad trim) + GELU, post-LN or pre-LN layers;
  * WavLMAttention with the T5-style bucketed relative position bias
    (computed once in layer 0, shared down the stack) and WavLM's gated
    relative position bias. Attention runs through kernel K2
    (``ops/flash_attention_cuda.py``) or the eager product.

Numerics follow the JAX package, which is what the port is held against:
every LayerNorm uses flax's default epsilon 1e-6 (the published torch
WavLM uses torch's 1e-5); the group norm and the wav normalisation use the
1e-5 the JAX code writes. The JAX package's three precisions are ported:

  * ``"highest"``: true float32 contractions, TF32 off (the features feed
    cosine ranks);
  * ``"default"``: what XLA's ``Precision.DEFAULT`` does on a TPU. Every
    contraction (the conv extractor, ``pos_conv``, the q/k/v/out
    projections, ``grep_linear``, ``fc1``/``fc2``, ``post_extract_proj``)
    rounds its operands to bfloat16 and sums in float32, with a float32
    output; LayerNorm, GELU, the gate's sigmoid and the softmax statistics
    stay float32; attention goes through K2 in bfloat16 (or, eager, through
    the same rounding). On the card the products are cuBLAS bfloat16 GEMMs
    with float32 outputs (``torch.mm``/``torch.bmm`` with ``out_dtype``);
    the convolutions are such GEMMs over unfolded windows, because cuDNN's
    bfloat16 convolutions round their outputs to bfloat16. The CPU rounds
    the same operands and multiplies in float32, so the two differ only in
    summation order. Where this differs from XLA's DEFAULT: on a CPU XLA
    computes DEFAULT in float32 (only the attention kernel rounds there),
    and the tensor cores' float32 accumulation is not IEEE round-to-nearest
    at every step.
  * ``"high"``: ``Precision.HIGH`` on a TPU, bf16x3. Each float32 operand
    x splits into hi = bf16(x) and lo = bf16(x - hi), and a contraction is
    hi.hi + (hi.lo + lo.hi): three bfloat16 products with float32 sums
    and outputs, the GEMMs and unfolded convolutions of ``"default"``
    (the lo.lo term, ~2^-16 relative, is dropped). Attention goes through
    K2 in float32, as the JAX wrapper passes float32 whenever the precision
    is not ``"default"``; the eager attention is float32 too. On a CPU XLA
    computes HIGH in float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops import flash_attention_cuda

LN_EPS = 1e-6       # flax nn.LayerNorm's default, as the JAX package uses
NORM_EPS = 1e-5     # group norm and wav normalisation, as the JAX code writes
PRECISIONS = ("highest", "high", "default")


@dataclass(frozen=True)
class WavLMConfig:
    """Copy of the JAX package's WavLMJaxConfig (WavLM-Large defaults).
    ``scan_layers`` has no counterpart: it chose how XLA compiles the
    stack."""
    encoder_layers: int = 24
    encoder_embed_dim: int = 1024
    encoder_ffn_embed_dim: int = 4096
    encoder_attention_heads: int = 16
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 2, 2), (512, 2, 2))
    extractor_mode: str = "layer_norm"   # 'default' | 'layer_norm'
    conv_bias: bool = True
    layer_norm_first: bool = True
    normalize: bool = True               # layer-norm the raw waveform
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True
    # "highest" = true float32 everywhere (TF32 off); "default" = bfloat16
    # operands, float32 sums and outputs in every contraction; "high" =
    # bf16x3, three such products of hi/lo bfloat16 splits (the module
    # docstring).
    precision: str = "highest"
    # "flash": kernel K2 (its plain version on the CPU); "eager": the
    # materialised softmax, the JAX package's "xla" branch; "auto": "flash"
    # on a CUDA device when a relative position bias exists, else "eager".
    attn_impl: str = "auto"

    @classmethod
    def base(cls) -> "WavLMConfig":
        return cls(encoder_layers=12, encoder_embed_dim=768,
                   encoder_ffn_embed_dim=3072, encoder_attention_heads=12,
                   extractor_mode="default", conv_bias=False,
                   layer_norm_first=False, normalize=False,
                   max_distance=1280)


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (M, K) @ (K, N) or (G, M, K) @ (G, K, N) bfloat16
    operands, with float32 sums and output: a
    cuBLAS bfloat16 GEMM that writes float32 on the card, a float32
    product of the (exactly widened) operands on the CPU."""
    mm = torch.mm if a.dim() == 2 else torch.bmm
    if a.is_cuda:
        return mm(a, b, out_dtype=torch.float32)
    return mm(a.float(), b.float())


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo + O(2^-16 |x|): hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def matmul_bf16x3(a: torch.Tensor, b) -> torch.Tensor:
    """float32 a @ b at the "high" precision (bf16x3): a_hi.b_hi + (a_hi.b_lo +
    a_lo.b_hi), three bfloat16 products with float32 sums and outputs. `b`
    is a float32 tensor or its (hi, lo) split (cached weight copies)."""
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b) if isinstance(b, torch.Tensor) else b
    return _mm_bf16(a_hi, b_hi) + (_mm_bf16(a_hi, b_lo)
                                   + _mm_bf16(a_lo, b_hi))


def bf16_copy(module: nn.Module, key: str, make) -> torch.Tensor:
    """A bfloat16 weight derived from `module`'s parameters by make(),
    kept on the module and made again only when a parameter changes (in
    place, as load_state_dict does, or by a move to another device)."""
    params = tuple(module.parameters(recurse=False))
    stamp = tuple((p.data_ptr(), p._version, p.device) for p in params)
    cache = module.__dict__.setdefault("_bf16_weights", {})
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = cache[key] = (stamp, make().to(torch.bfloat16))
    return hit[1]


def matmul_weight(module: nn.Module, x: torch.Tensor, key: str, make,
                  precision: str) -> torch.Tensor:
    """x @ w at "default" or "high", w = make() a float32 weight of
    `module` whose bfloat16 copies (hi, and lo for "high") are cached."""
    hi = bf16_copy(module, key, make)
    if precision == "default":
        return _mm_bf16(x.to(torch.bfloat16), hi)
    lo = bf16_copy(module, key + ".lo", lambda: make() - hi.float())
    return matmul_bf16x3(x, (hi, lo))


def linear(layer: nn.Linear, x: torch.Tensor, precision: str) -> torch.Tensor:
    """layer(x) at `precision`: "default" and "high" multiply bfloat16
    operands with float32 sums and add the float32 bias, as flax's Dense
    does."""
    if precision == "highest":
        return layer(x)
    y = matmul_weight(layer, x.reshape(-1, x.shape[-1]), "weight",
                      lambda: layer.weight.t(), precision)
    y = y.reshape(*x.shape[:-1], y.shape[-1])
    return y if layer.bias is None else y + layer.bias


class TransposeLast(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(-2, -1)


class ConvFeatureExtractor(nn.Module):
    """(B, n_samples) -> (B, frames, C). Block i is the Sequential
    (conv, dropout, norm, GELU) of Microsoft's ConvFeatureExtractionModel,
    so its keys are conv_layers.{i}.0 (conv), .2.1 (layer norm) and .2
    (block 0's group norm)."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        blocks = []
        c_in = 1
        for i, (dim, k, stride) in enumerate(cfg.conv_feature_layers):
            conv = nn.Conv1d(c_in, dim, k, stride=stride, bias=cfg.conv_bias)
            nn.init.kaiming_normal_(conv.weight)
            if cfg.extractor_mode == "layer_norm":
                norm = nn.Sequential(TransposeLast(),
                                     nn.LayerNorm(dim, eps=LN_EPS),
                                     TransposeLast())
            elif i == 0:
                norm = nn.GroupNorm(dim, dim, eps=NORM_EPS)
            else:
                norm = nn.Identity()
            blocks.append(nn.Sequential(conv, nn.Identity(), norm, nn.GELU()))
            c_in = dim
        self.conv_layers = nn.ModuleList(blocks)
        self.precision = cfg.precision

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if self.precision == "highest":
            x = wav[:, None, :]
            for block in self.conv_layers:
                x = block(x)
            return x.transpose(1, 2)
        x = wav[:, :, None]                                  # (B, L, 1)
        for block in self.conv_layers:
            x = conv_block_bf16(block, x, self.precision)
        return x


def conv_block_bf16(block: nn.Sequential, x: torch.Tensor,
                    precision: str = "default") -> torch.Tensor:
    """One extractor block at the "default" or "high" precision, channels
    last (B, L, C) -> (B, L', C'): the conv is a GEMM over its unfolded
    windows (bfloat16 operands, float32 out; three of them for "high"),
    then the float32 norm and GELU."""
    conv, _, norm, act = block
    k, stride = conv.kernel_size[0], conv.stride[0]
    cols = x.unfold(1, k, stride)                            # (B, L', C, k)
    B, L = cols.shape[:2]
    y = matmul_weight(conv, cols.reshape(B * L, -1), "weight",
                      lambda: conv.weight.reshape(conv.out_channels, -1).t(),
                      precision).view(B, L, -1)
    if conv.bias is not None:
        y = y + conv.bias
    if isinstance(norm, nn.Sequential):                      # layer norm
        y = norm[1](y)
    else:                                                    # group / none
        y = norm(y.transpose(1, 2)).transpose(1, 2)
    return act(y)


def relative_position_bucket(relative_positions: np.ndarray,
                             num_buckets: int, max_distance: int
                             ) -> np.ndarray:
    """T5 bidirectional bucketing (modules.py:419-444), host float64."""
    rp = relative_positions.astype(np.int64)
    nb = num_buckets // 2
    buckets = (rp > 0).astype(np.int64) * nb
    rp = np.abs(rp)
    max_exact = nb // 2
    is_small = rp < max_exact
    large = max_exact + (
        np.log(np.maximum(rp, 1).astype(np.float64) / max_exact)
        / math.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(is_small, rp, large)


def _resolve_attn_impl(impl: str, device: torch.device,
                       has_bias: bool) -> str:
    if impl == "auto":
        return "flash" if device.type == "cuda" and has_bias else "eager"
    if impl not in ("flash", "eager"):
        raise ValueError(f"attn_impl must be 'auto', 'flash' or 'eager', "
                         f"got {impl!r}")
    return impl


class WavLMAttention(nn.Module):
    """Self-attention with the gated relative position bias. Parameter
    names are those of Microsoft's MultiheadAttention."""

    def __init__(self, cfg: WavLMConfig, has_bias_table: bool):
        super().__init__()
        self.cfg = cfg
        D, H = cfg.encoder_embed_dim, cfg.encoder_attention_heads
        self.num_heads = H
        self.head_dim = D // H
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.q_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        if has_bias_table and cfg.relative_position_embedding:
            self.relative_attention_bias = nn.Embedding(cfg.num_buckets, H)
        if cfg.gru_rel_pos:
            self.grep_linear = nn.Linear(self.head_dim, 8)
            self.grep_a = nn.Parameter(torch.ones(1, H, 1, 1))
        self._buckets: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def position_bias(self, T: int) -> torch.Tensor:
        """(H, T, T) bias from the bucket table (layer 0 only)."""
        key = (T, self.relative_attention_bias.weight.device)
        if key not in self._buckets:
            pos = np.arange(T)
            self._buckets[key] = torch.as_tensor(relative_position_bucket(
                pos[None, :] - pos[:, None], self.cfg.num_buckets,
                self.cfg.max_distance), device=key[1])
        bias = self.relative_attention_bias.weight[self._buckets[key]]
        return bias.permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor,
                position_bias: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x: (B, T, D). Returns (out, position_bias (H, T, T))."""
        cfg = self.cfg
        B, T, D = x.shape
        H, hd = self.num_heads, self.head_dim
        if cfg.relative_position_embedding and position_bias is None:
            position_bias = self.position_bias(T)

        prec = cfg.precision
        q = linear(self.q_proj, x, prec).view(B, T, H, hd)
        k = linear(self.k_proj, x, prec).view(B, T, H, hd)
        v = linear(self.v_proj, x, prec).view(B, T, H, hd)

        gate = None
        if position_bias is not None and cfg.gru_rel_pos:
            # the gate input is the RAW hidden state split into heads, not
            # the q_proj output (modules.py:523-533, the fast path)
            g = linear(self.grep_linear, x.view(B, T, H, hd),
                       prec)                                   # (B,T,H,8)
            g = torch.sigmoid(g.transpose(1, 2)
                              .reshape(B, H, T, 2, 4).sum(-1))  # (B,H,T,2)
            gate_a, gate_b = g[..., 0], g[..., 1]              # (B,H,T)
            gate = gate_a * (gate_b * self.grep_a[..., 0] - 1.0) + 2.0

        impl = _resolve_attn_impl(cfg.attn_impl, x.device,
                                  position_bias is not None)
        scale = hd ** -0.5
        if impl == "flash" and position_bias is not None:
            # the kernel's bias layout and dtype, made once in layer 0 and
            # passed down the stack as it is
            kd = torch.bfloat16 if prec == "default" else torch.float32
            position_bias = flash_attention_cuda.prepare_bias(position_bias,
                                                              kd)
            out = flash_attention_cuda.gated_flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                position_bias, gate, sm_scale=scale, kernel_dtype=kd)
            out = out.transpose(1, 2)                          # (B,T,H,hd)
        else:
            # "default": bfloat16 operands of both products, float32 sums;
            # float32 otherwise, as K2 runs for "high"
            rnd = (lambda t: t.to(torch.bfloat16).float()) \
                if prec == "default" else (lambda t: t)
            scores = torch.einsum("bthd,bshd->bhts", rnd(q * scale), rnd(k))
            if position_bias is not None:
                bias = position_bias[None]                     # (1,H,T,T)
                if gate is not None:
                    bias = gate[..., None] * bias              # (B,H,T,T)
                scores = scores + bias
            attn = torch.softmax(scores, dim=-1)
            out = torch.einsum("bhts,bshd->bthd", rnd(attn), rnd(v))
        return linear(self.out_proj, out.reshape(B, T, D), prec), \
            position_bias


class WavLMLayer(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_bias_table: bool):
        super().__init__()
        self.layer_norm_first = cfg.layer_norm_first
        self.precision = cfg.precision
        D = cfg.encoder_embed_dim
        self.self_attn = WavLMAttention(cfg, has_bias_table)
        self.self_attn_layer_norm = nn.LayerNorm(D, eps=LN_EPS)
        self.fc1 = nn.Linear(D, cfg.encoder_ffn_embed_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_embed_dim, D)
        self.final_layer_norm = nn.LayerNorm(D, eps=LN_EPS)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(linear(self.fc1, x, self.precision))
        return linear(self.fc2, h, self.precision)

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor]):
        if self.layer_norm_first:
            h, position_bias = self.self_attn(self.self_attn_layer_norm(x),
                                              position_bias)
            x = x + h
            x = x + self._ffn(self.final_layer_norm(x))
        else:
            h, position_bias = self.self_attn(x, position_bias)
            x = self.self_attn_layer_norm(x + h)
            x = self.final_layer_norm(x + self._ffn(x))
        return x, position_bias


class WeightNormConv1d(nn.Module):
    """Grouped Conv1d under weight normalisation over dim 2:
    weight = weight_g / ||weight_v|| * weight_v, the norm taken over dims
    (0, 1) (torch.nn.utils.weight_norm(conv, dim=2), whose parameter names
    it keeps)."""

    def __init__(self, channels: int, kernel_size: int, groups: int):
        super().__init__()
        self.padding = kernel_size // 2
        self.groups = groups
        std = math.sqrt(4.0 / (kernel_size * channels))
        v = torch.randn(channels, channels // groups, kernel_size) * std
        self.weight_g = nn.Parameter(weight_norm(v))
        self.weight_v = nn.Parameter(v)
        self.bias = nn.Parameter(torch.zeros(channels))

    def weight(self) -> torch.Tensor:
        return self.weight_g / weight_norm(self.weight_v) * self.weight_v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight(), self.bias, padding=self.padding,
                        groups=self.groups)

    def forward_bf16(self, x: torch.Tensor,
                     precision: str = "default") -> torch.Tensor:
        """The "default" or "high" precision, channels last: (B, T, C) ->
        (B, T, C) with SamePad's trim for an even kernel applied, batched
        GEMMs (one per group) over the unfolded windows."""
        B, T, C = x.shape
        G, k = self.groups, self.weight_v.shape[-1]
        cg = C // G
        xp = F.pad(x, (0, 0, self.padding, self.padding))
        cols = xp.unfold(1, k, 1)[:, :T]                     # (B, T, C, k)
        cols = cols.reshape(B * T, G, cg * k).transpose(0, 1)
        y = matmul_weight(self, cols, "weight", lambda: self.weight().reshape(
            G, cg, cg * k).transpose(1, 2), precision)       # (G, B*T, cg)
        return y.transpose(0, 1).reshape(B, T, C) + self.bias


def weight_norm(v: torch.Tensor) -> torch.Tensor:
    """||v|| over dims (0, 1), shape (1, 1, k)."""
    return v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()


class SamePad(nn.Module):
    """Drop the trailing frame an even kernel adds."""

    def __init__(self, kernel_size: int):
        super().__init__()
        self.remove = 1 if kernel_size % 2 == 0 else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., :-self.remove] if self.remove else x


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        D = cfg.encoder_embed_dim
        self.pos_conv = nn.Sequential(
            WeightNormConv1d(D, cfg.conv_pos, cfg.conv_pos_groups),
            SamePad(cfg.conv_pos), nn.GELU())
        self.layers = nn.ModuleList(
            WavLMLayer(cfg, has_bias_table=(i == 0))
            for i in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(D, eps=LN_EPS)


class WavLM(nn.Module):
    """Raw 16 kHz wav -> features of the last layer (or of
    ``output_layer``), as the JAX package's WavLMJax."""

    def __init__(self, cfg: WavLMConfig = WavLMConfig(),
                 device: DeviceLike = "cuda"):
        super().__init__()
        if cfg.precision not in PRECISIONS:
            raise ValueError(f"WavLM precision {cfg.precision!r} is not one "
                             f"of the JAX package's {PRECISIONS}")
        self.cfg = cfg
        dev = resolve_device(device)
        self.feature_extractor = ConvFeatureExtractor(cfg)
        embed = cfg.conv_feature_layers[-1][0]
        self.layer_norm = nn.LayerNorm(embed, eps=LN_EPS)
        if embed != cfg.encoder_embed_dim:
            self.post_extract_proj = nn.Linear(embed, cfg.encoder_embed_dim)
        self.encoder = TransformerEncoder(cfg)
        self.eval().to(dev)

    @property
    def device(self) -> torch.device:
        return self.layer_norm.weight.device

    @torch.no_grad()
    def forward(self, wav: torch.Tensor,
                output_layer: Optional[int] = None) -> torch.Tensor:
        """(B, n_samples) float32 wav -> (B, frames, D) float32 features
        (extract_features, WavLM.py:323-376)."""
        cfg = self.cfg
        if cfg.normalize:
            mean = wav.mean(dim=-1, keepdim=True)
            var = wav.var(dim=-1, unbiased=False, keepdim=True)
            wav = (wav - mean) / torch.sqrt(var + NORM_EPS)
        feats = self.layer_norm(self.feature_extractor(wav))
        if hasattr(self, "post_extract_proj"):
            feats = linear(self.post_extract_proj, feats, cfg.precision)
        if cfg.precision == "highest":
            x_conv = self.encoder.pos_conv(
                feats.transpose(1, 2)).transpose(1, 2)
        else:
            x_conv = F.gelu(self.encoder.pos_conv[0].forward_bf16(
                feats, cfg.precision))
        x = feats + x_conv
        if not cfg.layer_norm_first:
            x = self.encoder.layer_norm(x)
        n_layers = cfg.encoder_layers if output_layer is None \
            else output_layer
        position_bias = None
        for layer in self.encoder.layers[:n_layers]:
            x, position_bias = layer(x, position_bias)
        if cfg.layer_norm_first and output_layer is None:
            x = self.encoder.layer_norm(x)
        return x


def wavlm_config_from_checkpoint(raw_cfg: dict) -> WavLMConfig:
    """The fields of a Microsoft checkpoint's 'cfg' that the JAX package's
    loader reads (conv_feature_layers keeps its default there too)."""
    d = WavLMConfig()
    return WavLMConfig(**{f: raw_cfg.get(f, getattr(d, f)) for f in (
        "encoder_layers", "encoder_embed_dim", "encoder_ffn_embed_dim",
        "encoder_attention_heads", "extractor_mode", "conv_bias",
        "layer_norm_first", "normalize", "relative_position_embedding",
        "num_buckets", "max_distance", "gru_rel_pos")})


def load_wavlm_checkpoint(path: str, device: DeviceLike = "cuda") -> WavLM:
    """Load a published WavLM .pt checkpoint (Microsoft's {"cfg", "model"}
    layout). Keys the port does not hold (``mask_emb``, training heads) are
    ignored; a key the port needs and the checkpoint lacks raises."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    cfg = wavlm_config_from_checkpoint(ckpt.get("cfg", {}))
    model = WavLM(cfg, device=device)
    sd = ckpt["model"]
    wanted = model.state_dict().keys()
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {len(missing)} WavLM "
                       f"tensors, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in wanted})
    return model
