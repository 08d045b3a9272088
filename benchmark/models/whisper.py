"""Whisper-large-v3's encoder as a cell's audio encoder: its weights under
``WhisperEncoder``'s names, the port's module built from the configuration,
the reference's forward and the check of the program's features against
it, the database's audio side (the 50 Hz features the wavlm modes stage),
the encoder's work from shapes, and the shape and work of its bias-free
attention (K2's ``nobias_flash_kernel``).

Each unit's clip is one utterance padded to 30 s, so the work is counted
per utterance: ceil(windows x 4 s / 30 s) of them a unit."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from benchmark.reference import whisper as ref_whisper
from benchmark.weights import Spec

AUDIO = "wavlm"            # staged as the same 50 Hz feature stack
CHECK = "enc_rel_err"      # the number the encoder is compared by


def spec(c: dict) -> Spec:
    D, F, M = c["d_model"], c["encoder_ffn_dim"], c["num_mel_bins"]

    def lin(name, n_out, n_in, bias=True):
        return [(f"{name}.weight", (n_out, n_in), "fan_in")] + \
            ([(f"{name}.bias", (n_out,), "bias")] if bias else [])

    def ln(name):
        return [(f"{name}.weight", (D,), "ln_w"),
                (f"{name}.bias", (D,), "bias")]

    s: Spec = [("conv1.weight", (D, M, 3), "fan_in"),
               ("conv1.bias", (D,), "bias"),
               ("conv2.weight", (D, D, 3), "fan_in"),
               ("conv2.bias", (D,), "bias"),
               ("embed_positions.weight", (c["max_source_positions"], D),
                "unit")]
    for layer in range(c["encoder_layers"]):
        p = f"layers.{layer}"
        s += lin(f"{p}.self_attn.k_proj", D, D, bias=False)
        for proj in ("v_proj", "q_proj", "out_proj"):
            s += lin(f"{p}.self_attn.{proj}", D, D)
        s += ln(f"{p}.self_attn_layer_norm")
        s += lin(f"{p}.fc1", F, D) + lin(f"{p}.fc2", D, F)
        s += ln(f"{p}.final_layer_norm")
    return s + ln("layer_norm")


def frames(cfg: dict, n_samples: int) -> int:
    """Encoder positions of one window: two mel frames each."""
    return n_samples // (2 * cfg["feature_extractor"]["hop_length"])


def utterances(cfg: dict, windows: int, n_samples: int) -> int:
    """30 s utterances of a unit of ``windows`` windows (one clip)."""
    return math.ceil(windows * n_samples
                     / cfg["feature_extractor"]["n_samples"])


def database_audio(cfg: dict, windows: int, n_samples: int,
                   g: torch.Generator, device) -> torch.Tensor:
    """(J, frames, d_model) float32 features of the database's windows."""
    return torch.randn(windows, frames(cfg, n_samples), cfg["d_model"],
                       generator=g, device=device)


def program(cfg: dict, device) -> torch.nn.Module:
    """The port's Whisper encoder as the configuration states it; a
    configuration the port cannot run as stated is refused."""
    from qpgesture_tpu_torch.models.whisper import (STEM_STRIDE,
                                                    WhisperConfig,
                                                    WhisperEncoder)
    from qpgesture_tpu_torch.ops import logmel as front
    port_fe = {
        "feature_size": cfg["num_mel_bins"],
        "sampling_rate": front.SAMPLE_RATE, "n_fft": front.N_FFT,
        "hop_length": front.HOP_LENGTH, "chunk_length": front.CHUNK_SECONDS,
        "n_samples": front.N_SAMPLES, "nb_max_frames": front.N_FRAMES,
        "padding_value": 0.0, "window": "hann_periodic",
        "mel_scale": "slaney", "mel_norm": "slaney", "f_min": 0.0,
        "f_max": front.MAX_HZ, "log_floor": front.LOG_FLOOR,
        "dynamic_range": front.DYNAMIC_RANGE}
    if not (cfg["activation_function"] == "gelu"
            and cfg["feature_extractor"] == port_fe
            and cfg["max_source_positions"] * STEM_STRIDE
            == front.N_FRAMES):
        raise ValueError("the port's Whisper runs exact GELU over "
                         f"WhisperFeatureExtractor's log-mel {port_fe} and "
                         "1500 positions; the configuration states "
                         "otherwise")
    if (cfg["precision"], cfg["tf32"]) != ("float32", False):
        raise ValueError("the benchmark runs Whisper at float32 with TF32 "
                         f"off; the configuration states "
                         f"{cfg['precision']!r}, tf32={cfg['tf32']}")
    return WhisperEncoder(WhisperConfig(
        d_model=cfg["d_model"], encoder_layers=cfg["encoder_layers"],
        encoder_attention_heads=cfg["encoder_attention_heads"],
        encoder_ffn_dim=cfg["encoder_ffn_dim"],
        num_mel_bins=cfg["num_mel_bins"],
        max_source_positions=cfg["max_source_positions"],
        layer_norm_eps=cfg["layer_norm_eps"]), device=device)


def reference(w: dict, cfg: dict, wav: torch.Tensor) -> torch.Tensor:
    """(n, samples) float32 wav of one utterance -> (n, frames, d_model)
    features."""
    return ref_whisper.features(w, cfg, wav)


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


def attn_shape(cfg: dict, windows: int, n_samples: int
               ) -> Tuple[int, int, int, int, int]:
    """(layers, utterances, heads, positions, head width) of the bias-free
    attention a unit of ``windows`` windows runs: every layer over all
    positions of each utterance, the padding included."""
    H = cfg["encoder_attention_heads"]
    return (cfg["encoder_layers"], utterances(cfg, windows, n_samples), H,
            cfg["max_source_positions"], cfg["d_model"] // H)


def attn_work(B: int, H: int, T: int, hd: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one float32 bias-free attention call over (B, H,
    T, hd): q k^T and p v, 4 B H T^2 hd; q, k and v read once, the output
    written once."""
    return 4.0 * B * H * T * T * hd, 4.0 * 4 * B * H * T * hd


def flops(cfg: dict, B: int, n_samples: int) -> float:
    """The conv stem, each layer's four projections and feed-forward as
    multiply-adds (2 per) and its attention over all positions, for each
    30 s utterance of B windows."""
    D, F = cfg["d_model"], cfg["encoder_ffn_dim"]
    T = cfg["max_source_positions"]
    mel_frames = cfg["feature_extractor"]["nb_max_frames"]
    stem = 2.0 * mel_frames * cfg["num_mel_bins"] * 3 * D \
        + 2.0 * T * D * 3 * D
    layers, _, H, _, hd = attn_shape(cfg, B, n_samples)
    per_layer = 2.0 * T * (4 * D * D + 2 * D * F) \
        + attn_work(1, H, T, hd)[0]
    return utterances(cfg, B, n_samples) * (stem + layers * per_layer)


def table_flops(cfg: dict, Q: int, N: int) -> float:
    """The audio side's cosine table of Q queries against N blocks of six
    stacked features."""
    return 2.0 * Q * N * 6 * cfg["d_model"]


def attention(cfg: dict, n_samples: int) -> Optional[Tuple[int, ...]]:
    """None: the gated K2 does not run in this encoder (its bias-free
    attention's shape is ``attn_shape``)."""
    return None
