"""vq-wav2vec as a cell's audio encoder: its weights under fairseq's names,
the port's module built from the configuration, the reference's forward
and the check of the program's codes against it (the widest gap by which
a served code's logit lies below the reference's best), the database's
audio side (code strings) and the encoder's work from shapes."""
from __future__ import annotations

from typing import Tuple

import torch

from benchmark import yardstick
from benchmark.reference import vq_wav2vec as ref_vq
from benchmark.weights import Spec

AUDIO = "wavvq"            # the keyword stage_database takes the audio by
CHECK = "enc_logit_gap"    # the number the encoder is compared by


def spec(c: dict) -> Spec:
    s: Spec = []
    c_in = 1
    for i, (dim, k) in enumerate(zip(c["conv_dim"], c["conv_kernel"])):
        p = f"feature_extractor.conv_layers.{i}"
        s += [(f"{p}.0.weight", (dim, c_in, k), "fan_in"),
              (f"{p}.2.weight", (dim,), "ln_w"),
              (f"{p}.2.bias", (dim,), "bias")]
        c_in = dim
    out = c["vq_groups"] * c["vq_vars"]
    p = "vector_quantizer.weight_proj"
    if c["vq_depth"] == 1:
        return s + [(f"{p}.weight", (out, c_in), "fan_in"),
                    (f"{p}.bias", (out,), "bias")]
    inner = c["vq_weight_proj_factor"] * c_in
    d_in = c_in
    for d in range(c["vq_depth"] - 1):
        s += [(f"{p}.{d}.0.weight", (inner, d_in), "fan_in"),
              (f"{p}.{d}.0.bias", (inner,), "bias")]
        d_in = inner
    return s + [(f"{p}.{c['vq_depth'] - 1}.weight", (out, inner), "fan_in"),
                (f"{p}.{c['vq_depth'] - 1}.bias", (out,), "bias")]


def frames(cfg: dict, n_samples: int) -> int:
    return yardstick.conv_frames(cfg, n_samples)


def database_audio(cfg: dict, windows: int, n_samples: int,
                   g: torch.Generator, device) -> torch.Tensor:
    """(J, frames, groups) int32 codes of the database's windows."""
    return torch.randint(0, cfg["vq_vars"], (windows, frames(cfg, n_samples),
                                             cfg["vq_groups"]),
                         generator=g, device=device, dtype=torch.int32)


def program(cfg: dict, device) -> torch.nn.Module:
    """The port's vq-wav2vec as the configuration states it; a
    configuration the port cannot run as stated is refused."""
    from qpgesture_tpu_torch.models.vq_wav2vec import (VQWav2Vec,
                                                       VQWav2VecConfig)
    if (cfg["precision"], cfg["tf32"]) != ("float32", False) \
            or cfg["conv_bias"] or cfg["vq_type"] != "gumbel" \
            or cfg["group_norm_eps"] != 1e-5:
        raise ValueError("the port's vq-wav2vec runs bias-free convs, group "
                         "norm eps 1e-5 and Gumbel codes at float32 with "
                         "TF32 off; the configuration states otherwise")
    return VQWav2Vec(VQWav2VecConfig(
        conv_layers=tuple(zip(cfg["conv_dim"], cfg["conv_kernel"],
                              cfg["conv_stride"])),
        activation=cfg["activation"], log_compression=cfg["log_compression"],
        skip_connections=cfg["skip_connections_feat"],
        groups=cfg["vq_groups"], num_vars=cfg["vq_vars"],
        weight_proj_depth=cfg["vq_depth"],
        weight_proj_factor=cfg["vq_weight_proj_factor"]), device=device)


def reference(w: dict, cfg: dict, wav: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, samples) float32 wav -> ((n, frames, groups) codes, logits)."""
    return ref_vq.codes(w, cfg, wav)


def served(out: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """What the program's encoder hands the matcher, from the reference's
    output: the codes."""
    return out[0]


def check(out: Tuple[torch.Tensor, torch.Tensor], enc: torch.Tensor
          ) -> float:
    """The widest gap by which the logit of a code the program served lies
    below the reference's best, over every frame and group."""
    logits = out[1]
    served_codes = enc.long().to(logits.device)
    gap = logits.max(-1).values - logits.gather(
        -1, served_codes[..., None])[..., 0]
    return float(gap.max())


def flops(cfg: dict, B: int, n_samples: int) -> float:
    return yardstick.vq_wav2vec_flops(cfg, B, n_samples)


def table_flops(cfg: dict, Q: int, N: int) -> float:
    """Edit distances are integer work: no floating-point operations."""
    return 0.0


def attention(cfg: dict, n_samples: int) -> None:
    """vq-wav2vec has no attention (K2 does not run)."""
    return None
