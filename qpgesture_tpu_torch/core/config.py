"""Typed configuration for the whole framework.

Supersedes the reference's argparse + YAML + EasyDict merge idiom
(codebook/configs/parse_args.py:4-18, codebook/train.py:151-163) with one
dataclass tree. Matching mode flags that the reference hard-codes at call
sites (GestureKNN.py:842-843) or overrides inside the loop (use_freq=True at
GestureKNN.py:542) are explicit, documented fields here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import constants as C


@dataclass(frozen=True)
class VQVAEConfig:
    """Gesture VQ-VAE hyperparameters (codebook/configs/codebook.yml:1-25)."""
    levels: int = 1
    downs_t: Tuple[int, ...] = (3,)
    strides_t: Tuple[int, ...] = (2,)
    emb_width: int = 512
    l_bins: int = 512            # codebook entries
    l_mu: float = 0.99           # EMA decay for codebook updates
    commit: float = 0.02
    hvqvae_multipliers: Tuple[int, ...] = (1,)
    width: int = 512
    depth: int = 3
    m_conv: float = 1.0
    dilation_growth_rate: int = 3
    dilation_cycle: Optional[int] = None
    sample_length: int = 30
    use_bottleneck: bool = True
    joint_channel: int = 9
    vel: float = 1.0
    acc: float = 1.0
    reg: float = 0.0
    vqvae_reverse_decoder_dilation: bool = True
    input_dim: int = C.POSE_DIM
    # "highest" = true f32 (checkpoint parity); "default" = bf16 multiplies
    # with f32 accumulate; "high" = bf16x3 (models/encdec.py).
    conv_precision: str = "highest"
    # Opt-in activation checkpointing of the residual conv blocks
    # (nn.remat): trades recompute for activation memory, matching the
    # reference's checkpoint_res (models/utils/checkpoint.py:4-32, wired at
    # resnet.py:63-75). Off by default, like the reference.
    checkpoint_res: bool = False

    @property
    def hop_length(self) -> int:
        h = 1
        for s, d in zip(self.strides_t, self.downs_t):
            h *= s ** d
        return h


@dataclass(frozen=True)
class PAEConfig:
    """Periodic autoencoder hyperparameters (codebook/PAE.py:27-47)."""
    window: float = 4.0
    frames: int = 240
    keys: int = 13
    joints: int = 15
    channels_per_joint: int = 9
    phase_channels: int = 8
    epochs: int = 100
    save_per_epochs: int = 10
    n_poses: int = 240
    subdivision_stride: int = 1
    batch_size: int = 1
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    restart_period: int = 10
    restart_mult: int = 2
    loss_weight: float = 300.0

    @property
    def input_channels(self) -> int:
        return self.joints * self.channels_per_joint


@dataclass(frozen=True)
class End2EndConfig:
    """GRU baseline trainer config (codebook.yml:51-57)."""
    lr: float = 2e-4
    epochs: int = 100
    betas: Tuple[float, float] = (0.99, 0.999)
    save_per_epochs: int = 10
    hidden_size: int = 200
    output_size: int = C.CODEBOOK_SIZE


@dataclass(frozen=True)
class ResyncConfig:
    """ResyncNet WGAN-GP trainer config
    (Speech2GestureMatching/constant.py:28-36)."""
    batch_size: int = 100
    lr: float = 1e-4
    max_iters: int = 300000
    burnin_iters: int = 10000   # gates best-model selection only (fit():142)
    weight_gen: float = 1.0
    weight_recon: float = 0.1
    lambda_gp: float = 100.0
    gen_hop: int = 5
    # Adam(lr, weight_decay=4e-5, betas=(0.0, 0.9)) — the WGAN-GP setting
    # (train_resync_gestureknn.py:172-173)
    weight_decay: float = 4e-5
    betas: Tuple[float, float] = (0.0, 0.9)


@dataclass(frozen=True)
class MatchConfig:
    """Motion-matching engine configuration.

    The reference's shipped flags (`bash GestureKNN.sh`) correspond to
    ``audio_mode='wavlm_feat', use_phase=True, use_txt=True, use_aud=True``
    (GestureKNN.py:842-843). The wavvq/Levenshtein mode is
    ``audio_mode='wavvq_feat'``. ``use_freq`` is hard-coded True inside the
    reference loop (GestureKNN.py:542) so it defaults to True here.
    """
    audio_mode: str = "wavlm_feat"  # wavvq_feat | wavlm_feat | wavlm | feat | audio
    use_aud: bool = True
    use_txt: bool = True
    use_phase: bool = True
    use_freq: bool = True
    freq_weight: float = 0.05       # GestureKNN.py:545
    desired_k: int = 0
    step_sz: int = C.STEP_SZ
    codebook_size: int = C.CODEBOOK_SIZE
    num_frames_code: int = C.NUM_FRAMES_CODE
    num_frames: int = C.NUM_FRAMES
    seed: int = 123456              # GestureKNN.py:19-22
    unmatched_dist: float = 1e3     # GestureKNN.py:668,709
    # Levenshtein string construction mode for wavvq ('combine' per
    # GestureKNN.py:677; 'sum' also supported per wavvq_distances:44-55).
    wavvq_mode: str = "combine"
    # Cross-window seed chaining. The reference passes seed_code/seed_phase
    # only in the wavvq and wavlm_feat dispatch paths
    # (GestureKNN.py:789-802); the mfcc ('feat'/'audio') and raw-wavlm
    # dispatches call search_code_knn without seeds, so each window draws a
    # fresh random init (GestureKNN.py:797,804,806).
    chain_windows: bool = True
    # MXU precision of the AUDIO-feature cosine distance matmul (the
    # dominant device cost of the wavlm_feat/shipped mode; the text side
    # always runs HIGHEST — it is a 384-d matmul, too cheap to matter).
    #   'highest' — 6-pass f32 emulation, the bit-parity reference point;
    #   'high'    — 3-pass bf16x3 (~f32-accurate: input-split residual
    #               ~2^-18 vs HIGHEST's ~2^-24; rank flips need near-exact
    #               distance ties), ~2x faster candidate tables;
    #   'default' — 1-pass bf16 multiplies (~1e-3 distance perturbation —
    #               flips ranks between near-equal blocks; speed probe only).
    # Parity of 'high' vs the f32 oracle is verified empirically on-chip
    # (examples/chip_parity_sweep.py --cosine-precision high).
    cosine_precision: str = "highest"
    # HBM residency dtype of the AUDIO feature database (cosine modes only;
    # wavvq strings are int32 and the 384-d text side is too small to
    # matter). The dominant resident tensor in wavlm_feat mode is the
    # (J*26, 6144) feature DB — 10.6 GB f32 at J=16384, which plus program
    # temps exceeds a 16 GB chip. 'bfloat16'/'float16' halve it:
    #   'float32'  — the bit-parity reference point;
    #   'float16'  — 11-bit mantissa (~2^-11 feature rounding; features are
    #                L2-normalized so the narrow f16 range is irrelevant) —
    #                the accuracy-preferred residency mode;
    #   'bfloat16' — 8-bit mantissa (~2^-8 rounding), native MXU input.
    # Low-precision residency also runs the distance matmul at that input
    # precision (upcasting in-program would materialize the DB-sized f32
    # temp this knob exists to avoid), so cosine_precision is moot then.
    # Index parity vs the f32 oracle is an empirical question per database —
    # quantify with examples/chip_parity_sweep.py --feat-dtype.
    feat_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    """VQ-VAE trainer envelope (codebook.yml:35-49, train.py:84-85)."""
    n_poses: int = 240
    n_codes: int = 30
    motion_fps: int = 60
    subdivision_stride: int = 32
    batch_size: int = 256
    epochs: int = 500
    save_per_epochs: int = 25
    lr: float = 3e-5
    betas: Tuple[float, float] = (0.5, 0.999)
    milestones: Tuple[int, ...] = (100, 200)
    gamma: float = 0.1
    model_save_path: str = "./output/train_codebook"
    name: str = "codebook"
    loader_workers: int = 2
    # TPU additions
    mesh_shape: Optional[Tuple[int, ...]] = None  # None -> all devices, 1-D dp
    dtype: str = "float32"


@dataclass(frozen=True)
class Config:
    vqvae: VQVAEConfig = field(default_factory=VQVAEConfig)
    pae: PAEConfig = field(default_factory=PAEConfig)
    end2end: End2EndConfig = field(default_factory=End2EndConfig)
    resync: ResyncConfig = field(default_factory=ResyncConfig)
    match: MatchConfig = field(default_factory=MatchConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data_mean: Optional[List[float]] = None
    data_std: Optional[List[float]] = None
    train_data_path: str = ""
    val_data_path: str = ""


def _build(cls, data: Dict[str, Any]):
    """Construct dataclass `cls` from a dict, recursing into nested fields and
    ignoring unknown keys (so reference-era YAML files still load)."""
    import typing
    kwargs = {}
    # resolve string annotations (PEP 563: f.type is a str under
    # `from __future__ import annotations`) so nested dataclass fields
    # actually recurse instead of receiving the raw dict
    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            continue
        f = fields[key]
        ftype = hints.get(key, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype) \
                and isinstance(value, dict):
            kwargs[key] = _build(ftype, value)
        elif isinstance(value, list) and isinstance(f.default, tuple):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


# Map the reference YAML's section names to our fields.
_SECTION_MAP = {
    "VQVAE": ("vqvae", VQVAEConfig),
    "PAE": ("pae", PAEConfig),
    "end2end": ("end2end", End2EndConfig),
    "resync": ("resync", ResyncConfig),
    "match": ("match", MatchConfig),
}

_TRAIN_KEYS = {f.name for f in dataclasses.fields(TrainConfig)}


def load_config(path: str) -> Config:
    """Load a YAML config, accepting both this framework's layout and the
    reference's codebook.yml layout (codebook/configs/codebook.yml)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}

    sections: Dict[str, Any] = {}
    train_section: Dict[str, Any] = {}
    for key, value in raw.items():
        if key in _SECTION_MAP:
            name, cls = _SECTION_MAP[key]
            sections[name] = _build(cls, value)
        elif key in _TRAIN_KEYS:
            train_section[key] = value
        elif key == "motion_resampling_framerate":
            train_section["motion_fps"] = value
        elif key in ("data_mean", "data_std", "train_data_path",
                     "val_data_path"):
            sections[key] = value
    if train_section:
        sections["train"] = _build(TrainConfig, train_section)
    return Config(**sections)


# Mode presets: {mfcc, wavlm, wavvq} x guidance flags, replacing the
# reference's hard-coded call sites (GestureKNN.py:789-806).
MATCH_PRESETS: Dict[str, MatchConfig] = {
    # The paper's shipped configuration (WavLM cosine + text + phase).
    "shipped": MatchConfig(audio_mode="wavlm_feat", use_aud=True,
                           use_txt=True, use_phase=True),
    # Production serving point for the shipped mode: the audio distance
    # matmul runs 3-pass bf16x3 ('high') — ~2x faster candidate tables,
    # empirically index-identical to 'highest' across the on-chip parity
    # sweep (chip_parity_sweep --cosine-precision high, 21/21 clean; see
    # bench.py tables_ms_high). Everything else identical to "shipped".
    "shipped_fast": MatchConfig(audio_mode="wavlm_feat", use_aud=True,
                                use_txt=True, use_phase=True,
                                cosine_precision="high"),
    # wavvq Levenshtein path fed by wavvq_240.npz (GestureKNN.sh:2,17).
    "wavvq": MatchConfig(audio_mode="wavvq_feat", use_aud=True,
                         use_txt=True, use_phase=True),
    "wavvq_aud_only": MatchConfig(audio_mode="wavvq_feat", use_aud=True,
                                  use_txt=False, use_phase=False),
    "mfcc": MatchConfig(audio_mode="feat", use_aud=True, use_txt=False,
                        use_phase=False, chain_windows=False),
    # raw (unstacked) audio modes: consecutive frames flattened per block
    # (GestureKNN.py:562-563,571-572). The reference's dispatch for these
    # passes no guidance flags (predict_code_from_audio:797,806) which
    # appends nothing — here they run as audio-only searches. Like the mfcc
    # dispatch, the reference passes no seeds here, so windows don't chain.
    "wavlm_raw": MatchConfig(audio_mode="wavlm", use_aud=True,
                             use_txt=False, use_phase=False,
                             chain_windows=False),
    "mfcc_raw": MatchConfig(audio_mode="audio", use_aud=True,
                            use_txt=False, use_phase=False,
                            chain_windows=False),
    "no_phase": MatchConfig(audio_mode="wavlm_feat", use_aud=True,
                            use_txt=True, use_phase=False),
    "no_text": MatchConfig(audio_mode="wavlm_feat", use_aud=True,
                           use_txt=False, use_phase=True),
    "no_audio": MatchConfig(audio_mode="wavlm_feat", use_aud=False,
                            use_txt=True, use_phase=True),
}
