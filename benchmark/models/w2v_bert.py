"""w2v-BERT 2.0 as a cell's audio encoder: its weights under
``Wav2Vec2BertModel``'s names, the port's module built from the
configuration, the reference's forward and the check of the program's
features against it, the database's audio side (the 50 Hz features the
wavlm modes stage), the encoder's work from shapes, and the shape and work
of its attention kernel K4."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from benchmark.reference import w2v_bert as ref_w2v_bert
from benchmark.weights import Spec

AUDIO = "wavlm"            # staged as the same 50 Hz feature stack
CHECK = "enc_rel_err"      # the number the encoder is compared by


def spec(c: dict) -> Spec:
    D, F = c["hidden_size"], c["intermediate_size"]
    H, k = c["num_attention_heads"], c["conv_depthwise_kernel_size"]
    n_rel = c["left_max_position_embeddings"] \
        + c["right_max_position_embeddings"] + 1
    d_in = c["feature_projection_input_dim"]

    def ln(name, n):
        return [(f"{name}.weight", (n,), "ln_w"),
                (f"{name}.bias", (n,), "bias")]

    def lin(name, n_out, n_in):
        return [(f"{name}.weight", (n_out, n_in), "fan_in"),
                (f"{name}.bias", (n_out,), "bias")]

    def ffn(name):
        return lin(f"{name}.intermediate_dense", F, D) + \
            lin(f"{name}.output_dense", D, F)

    s: Spec = ln("feature_projection.layer_norm", d_in) + \
        lin("feature_projection.projection", D, d_in)
    for layer in range(c["num_hidden_layers"]):
        p = f"encoder.layers.{layer}"
        s += ln(f"{p}.ffn1_layer_norm", D) + ffn(f"{p}.ffn1")
        s += ln(f"{p}.self_attn_layer_norm", D)
        for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
            s += lin(f"{p}.self_attn.{proj}", D, D)
        s.append((f"{p}.self_attn.distance_embedding.weight",
                  (n_rel, D // H), "unit"))
        c_ = f"{p}.conv_module"
        s += ln(f"{c_}.layer_norm", D)
        s += [(f"{c_}.pointwise_conv1.weight", (2 * D, D, 1), "fan_in"),
              (f"{c_}.depthwise_conv.weight", (D, 1, k), "fan_in")]
        s += ln(f"{c_}.depthwise_layer_norm", D)
        s.append((f"{c_}.pointwise_conv2.weight", (D, D, 1), "fan_in"))
        s += ln(f"{p}.ffn2_layer_norm", D) + ffn(f"{p}.ffn2")
        s += ln(f"{p}.final_layer_norm", D)
    return s


def frames(cfg: dict, n_samples: int) -> int:
    fb = cfg["fbank"]
    n = (n_samples - fb["frame_length"]) // fb["hop_length"] + 1
    return n // fb["stride"]


def database_audio(cfg: dict, windows: int, n_samples: int,
                   g: torch.Generator, device) -> torch.Tensor:
    """(J, frames, hidden) float32 features of the database's windows."""
    return torch.randn(windows, frames(cfg, n_samples), cfg["hidden_size"],
                       generator=g, device=device)


def program(cfg: dict, device) -> torch.nn.Module:
    """The port's w2v-BERT as the configuration states it; a configuration
    the port cannot run as stated is refused."""
    from qpgesture_tpu_torch.models.w2v_bert import W2VBert, W2VBertConfig
    from qpgesture_tpu_torch.ops import fbank as front
    port_fbank = {
        "sample_rate": front.SAMPLE_RATE, "frame_length": front.FRAME_LENGTH,
        "hop_length": front.HOP_LENGTH, "fft_length": front.FFT_LENGTH,
        "mel_bins": front.MEL_BINS, "low_hz": front.MIN_FREQUENCY,
        "preemphasis": front.PREEMPHASIS, "window_power": front.WINDOW_POWER,
        "mel_floor": front.MEL_FLOOR, "norm_eps": front.NORM_EPS,
        "stride": front.STRIDE}
    if not (cfg["hidden_act"] == "swish"
            and cfg["position_embeddings_type"] == "relative_key"
            and not cfg["add_adapter"] and cfg["fbank"] == port_fbank):
        raise ValueError("the port's w2v-BERT runs swish, relative_key "
                         "attention, no adapter and SeamlessM4T's Kaldi "
                         f"fbank {port_fbank}; the configuration states "
                         "otherwise")
    if (cfg["precision"], cfg["tf32"]) != ("float32", False):
        raise ValueError("the benchmark runs w2v-BERT at float32 with TF32 "
                         f"off; the configuration states "
                         f"{cfg['precision']!r}, tf32={cfg['tf32']}")
    return W2VBert(W2VBertConfig(
        hidden_size=cfg["hidden_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        feature_projection_input_dim=cfg["feature_projection_input_dim"],
        left_max_position_embeddings=cfg["left_max_position_embeddings"],
        right_max_position_embeddings=cfg["right_max_position_embeddings"],
        conv_depthwise_kernel_size=cfg["conv_depthwise_kernel_size"],
        layer_norm_eps=cfg["layer_norm_eps"]), device=device)


def reference(w: dict, cfg: dict, wav: torch.Tensor) -> torch.Tensor:
    """(n, samples) float32 wav -> (n, frames, hidden) features."""
    return ref_w2v_bert.features(w, cfg, wav)


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


def relkey(cfg: dict, n_samples: int) -> Tuple[int, int, int, int, int]:
    """(layers, heads, frames, head width, distances) of the attention K4
    runs for one window."""
    H = cfg["num_attention_heads"]
    n_rel = cfg["left_max_position_embeddings"] \
        + cfg["right_max_position_embeddings"] + 1
    return (cfg["num_hidden_layers"], H, frames(cfg, n_samples),
            cfg["hidden_size"] // H, n_rel)


def relkey_work(B: int, H: int, T: int, hd: int, n_rel: int
                ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one float32 relative-key attention call over (B,
    H, T, hd): q k^T and p v, 4 B H T^2 hd, and q E^T, 2 B H T n_rel hd;
    q, k, v and E read once, the output written once."""
    ops = 4.0 * B * H * T * T * hd + 2.0 * B * H * T * n_rel * hd
    return ops, 4.0 * (4 * B * H * T * hd + n_rel * hd)


def flops(cfg: dict, B: int, n_samples: int) -> float:
    """The feature projection, each layer's two feed-forward blocks, four
    attention projections, two pointwise and one depthwise convolution as
    multiply-adds (2 per), and K4's work."""
    T = frames(cfg, n_samples)
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    per_layer = 2.0 * T * (4 * D * F + 4 * D * D + 3 * D * D) \
        + 2.0 * T * D * cfg["conv_depthwise_kernel_size"]
    layers, H, _, hd, n_rel = relkey(cfg, n_samples)
    attn = relkey_work(1, H, T, hd, n_rel)[0]
    proj = 2.0 * T * cfg["feature_projection_input_dim"] * D
    return B * (proj + layers * (per_layer + attn))


def table_flops(cfg: dict, Q: int, N: int) -> float:
    """The audio side's cosine table of Q queries against N blocks of six
    stacked features."""
    return 2.0 * Q * N * 6 * cfg["hidden_size"]


def attention(cfg: dict, n_samples: int) -> Optional[Tuple[int, ...]]:
    """None: K2 does not run in this encoder (K4's shape is ``relkey``)."""
    return None
