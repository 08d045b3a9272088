"""WavLM as a cell's audio encoder: its weights under Microsoft's names, the
port's module built from the configuration, the reference's forward and
the check of the program's features against it, the database's audio side
(stacked features) and the encoder's work from shapes."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark import yardstick
from benchmark.reference import wavlm as ref_wavlm
from benchmark.weights import Spec

AUDIO = "wavlm"            # the keyword stage_database takes the audio by
CHECK = "enc_rel_err"      # the number the encoder is compared by


def spec(c: dict) -> Spec:
    s: Spec = []
    c_in = 1
    for i, (dim, k) in enumerate(zip(c["conv_dim"], c["conv_kernel"])):
        p = f"feature_extractor.conv_layers.{i}"
        s.append((f"{p}.0.weight", (dim, c_in, k), "fan_in"))
        if c["conv_bias"]:
            s.append((f"{p}.0.bias", (dim,), "bias"))
        s += [(f"{p}.2.1.weight", (dim,), "ln_w"),
              (f"{p}.2.1.bias", (dim,), "bias")]
        c_in = dim
    D, F, H = c["hidden_size"], c["intermediate_size"], \
        c["num_attention_heads"]
    k, g = c["num_conv_pos_embeddings"], c["num_conv_pos_embedding_groups"]
    s += [("layer_norm.weight", (c_in,), "ln_w"),
          ("layer_norm.bias", (c_in,), "bias"),
          ("post_extract_proj.weight", (D, c_in), "fan_in"),
          ("post_extract_proj.bias", (D,), "bias"),
          ("encoder.pos_conv.0.weight_g", (1, 1, k), "weight_g"),
          ("encoder.pos_conv.0.weight_v", (D, D // g, k), "fan_in"),
          ("encoder.pos_conv.0.bias", (D,), "bias")]
    for layer in range(c["num_hidden_layers"]):
        p = f"encoder.layers.{layer}"
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            s += [(f"{p}.self_attn.{proj}.weight", (D, D), "fan_in"),
                  (f"{p}.self_attn.{proj}.bias", (D,), "bias")]
        if layer == 0:
            s.append((f"{p}.self_attn.relative_attention_bias.weight",
                      (c["num_buckets"], H), "unit"))
        s += [(f"{p}.self_attn.grep_linear.weight", (8, D // H), "fan_in"),
              (f"{p}.self_attn.grep_linear.bias", (8,), "bias"),
              (f"{p}.self_attn.grep_a", (1, H, 1, 1), "ln_w"),
              (f"{p}.self_attn_layer_norm.weight", (D,), "ln_w"),
              (f"{p}.self_attn_layer_norm.bias", (D,), "bias"),
              (f"{p}.fc1.weight", (F, D), "fan_in"),
              (f"{p}.fc1.bias", (F,), "bias"),
              (f"{p}.fc2.weight", (D, F), "fan_in"),
              (f"{p}.fc2.bias", (D,), "bias"),
              (f"{p}.final_layer_norm.weight", (D,), "ln_w"),
              (f"{p}.final_layer_norm.bias", (D,), "bias")]
    s += [("encoder.layer_norm.weight", (D,), "ln_w"),
          ("encoder.layer_norm.bias", (D,), "bias")]
    return s


def frames(cfg: dict, n_samples: int) -> int:
    return yardstick.conv_frames(cfg, n_samples)


def database_audio(cfg: dict, windows: int, n_samples: int,
                   g: torch.Generator, device) -> torch.Tensor:
    """(J, frames, hidden) float32 features of the database's windows."""
    return torch.randn(windows, frames(cfg, n_samples), cfg["hidden_size"],
                       generator=g, device=device)


def program(cfg: dict, device) -> torch.nn.Module:
    """The port's WavLM as the configuration states it; a configuration
    the port cannot run as stated is refused."""
    from qpgesture_tpu_torch.models.wavlm import WavLM, WavLMConfig
    if not (cfg["feat_extract_norm"] == "layer"
            and cfg["do_stable_layer_norm"] and cfg["normalize_wav"]
            and cfg["gru_rel_pos"] and cfg["layer_norm_eps"] == 1e-6
            and cfg["wav_norm_eps"] == 1e-5):
        raise ValueError("the port's WavLM runs WavLM-Large's layer-norm "
                         "extractor, pre-LN layers, normalized wav and "
                         "gated bias, with LayerNorm eps 1e-6 and wav "
                         "eps 1e-5; the configuration states otherwise")
    if (cfg["precision"], cfg["tf32"]) != ("float32", False):
        raise ValueError("the benchmark runs WavLM at float32 with TF32 off "
                         "(the port's \"highest\"); the configuration "
                         f"states {cfg['precision']!r}, tf32={cfg['tf32']}")
    return WavLM(WavLMConfig(
        encoder_layers=cfg["num_hidden_layers"],
        encoder_embed_dim=cfg["hidden_size"],
        encoder_ffn_embed_dim=cfg["intermediate_size"],
        encoder_attention_heads=cfg["num_attention_heads"],
        conv_feature_layers=tuple(zip(cfg["conv_dim"], cfg["conv_kernel"],
                                      cfg["conv_stride"])),
        extractor_mode="layer_norm", conv_bias=cfg["conv_bias"],
        layer_norm_first=True, normalize=True,
        conv_pos=cfg["num_conv_pos_embeddings"],
        conv_pos_groups=cfg["num_conv_pos_embedding_groups"],
        num_buckets=cfg["num_buckets"],
        max_distance=cfg["max_bucket_distance"], gru_rel_pos=True,
        precision="highest"), device=device)


def reference(w: dict, cfg: dict, wav: torch.Tensor) -> torch.Tensor:
    """(n, samples) float32 wav -> (n, frames, hidden) features."""
    return ref_wavlm.features(w, cfg, wav)


def served(out: torch.Tensor) -> torch.Tensor:
    """What the program's encoder hands the matcher, from the reference's
    output: the features themselves."""
    return out


def check(out: torch.Tensor, enc: torch.Tensor) -> float:
    """The largest relative Frobenius error of a window of the program's
    features ``enc`` against the reference's ``out``."""
    p = enc.float().to(out.device)
    err = (p - out).flatten(1).norm(dim=1) / out.flatten(1).norm(dim=1)
    return float(err.max())


def flops(cfg: dict, B: int, n_samples: int) -> float:
    return sum(yardstick.wavlm_flops(cfg, B, n_samples))


def table_flops(cfg: dict, Q: int, N: int) -> float:
    """The audio side's cosine table of Q queries against N blocks of six
    stacked features."""
    return 2.0 * Q * N * 6 * cfg["hidden_size"]


def attention(cfg: dict, n_samples: int) -> Optional[Tuple[int, ...]]:
    """(layers, heads, frames, head width) of the attention K2 runs for one
    window."""
    H = cfg["num_attention_heads"]
    return (cfg["num_hidden_layers"], H, frames(cfg, n_samples),
            cfg["hidden_size"] // H)
