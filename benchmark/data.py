"""The data of a run, drawn from its seed: the speaker database, the decoder's
data statistics, and the units of traffic (the general generator every
traffic mix's data file parameterises; the mix's entry gives a unit's
layout of windows and clips).

The database is drawn on the device in a few large calls and handed to the
program and to the reference as host arrays in the shapes and types of a
``DatabaseBundle``. A unit (one request, one tick or one batch) draws its
own inputs from (seed, unit index), so its inputs do not depend on how many
units a run reaches, and no two units share an input.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .weights import generator

WINDOW_SAMPLES = 64000      # a database window: 4 s at 16 kHz
POSE_FRAMES = 240
CODES = 30
PHASE_SHAPE = (4, 8)
POSE_DIM = 135


@dataclass
class Database:
    codes: np.ndarray          # (J, 30) int32 VQ-VAE codes of each window
    context: np.ndarray        # (J, 30, 384) float32 context embeddings
    phase: np.ndarray          # (J, 240, 4, 8) float32 PAE phase channels
    signature: np.ndarray      # (512, 135) float32 code signatures
    audio: np.ndarray          # (J, 199, D) float32 or (J, 398, 2) int32
    data_mean: np.ndarray      # (135,) float32 pose statistics
    data_std: np.ndarray       # (135,) float32


def database(cfg: dict, model, seed: int, device) -> Database:
    """The configuration's speaker database, drawn on ``device``; its audio
    side is ``model``'s (features or code strings)."""
    g = generator(seed, 10, device)
    m = cfg["match"]
    J, K = cfg["database"]["windows"], m["codebook_size"]

    def host(x):
        return x.cpu().numpy()

    codes = host(torch.randint(0, K, (J, CODES), generator=g, device=device,
                               dtype=torch.int32))
    context = host(torch.randn(J, CODES, m["context_dim"], generator=g,
                               device=device))
    phase = host(torch.rand(J, POSE_FRAMES, *PHASE_SHAPE, generator=g,
                            device=device))
    signature = host(torch.randn(K, POSE_DIM, generator=g, device=device))
    audio = host(model.database_audio(cfg, J, WINDOW_SAMPLES, g, device))
    stats = host(torch.randn(2, POSE_DIM, generator=g, device=device))
    return Database(codes, context, phase, signature, audio,
                    data_mean=stats[0] * 0.1,
                    data_std=np.abs(stats[1]) * 0.5 + 0.05)


@dataclass
class Unit:
    """One unit of traffic: wav (..., samples) int16, context (..., 30,
    384) float32, and the seed codes and phases of its clips or streams
    (present for clips; a pool's streams carry their own)."""
    index: int
    wav: np.ndarray
    context: np.ndarray
    init_codes: Optional[np.ndarray] = None
    init_phases: Optional[np.ndarray] = None


def _rng(seed: int, index: int, tag: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed, tag, index + 2 ** 20])))


def unit(traffic: dict, entry, cfg: dict, seed: int, index: int) -> Unit:
    """Unit ``index`` of the mix (negative indices: the warm-up's): a wav
    window and its context at each place of ``entry.lead(traffic)``, and
    the seed code and phase of each of its ``entry.clips(traffic)``
    clips."""
    r = _rng(seed, index, 20)
    lead = tuple(entry.lead(traffic))
    span = traffic["wav_range"]
    wav = r.integers(-span, span, lead + (traffic["samples"],),
                     dtype=np.int16)
    ctx = r.standard_normal(lead + (CODES, cfg["match"]["context_dim"]),
                            dtype=np.float32)
    n = entry.clips(traffic)
    if not n:
        return Unit(index, wav, ctx)
    return Unit(index, wav, ctx, *carry_seeds(r, cfg, n))


def carry_seeds(r: np.random.Generator, cfg: dict, n: int):
    """(codes (n,), phases (n, 8, 16)): n clips' or streams' seeds."""
    return (r.integers(0, cfg["match"]["codebook_size"], n),
            r.random((n, 8, 16), dtype=np.float32))


def stream_seeds(cfg: dict, seed: int, n: int):
    """The seeds n carried streams start from."""
    return carry_seeds(_rng(seed, -1, 30), cfg, n)


def check_sample(traffic: dict, seed: int, n_done_low: int) -> list:
    """The units whose outputs the comparison reads: drawn from the seed
    among the first ``n_done_low`` units, which every run reaches."""
    k = min(traffic["check_units"], n_done_low)
    r = _rng(seed, -2, 40)
    return sorted(int(i) for i in r.choice(n_done_low, k, replace=False))
