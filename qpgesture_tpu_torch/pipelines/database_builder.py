"""The database-builder helpers of the raw-wav ``generate`` path.

The port of part of ``qpgesture_tpu/pipelines/database_builder.py``: test
audio windowing (make_test_data.py:18-33), feature extraction with the
port's encoders (wav_to_wavlm, make_beat_dataset.py:337-385; wav_to_vq,
:388-429) and the hashed stand-in sentence embedding. The rest of the
builder is still to be ported.
"""
from __future__ import annotations

import math
import zlib
from typing import List

import numpy as np
import torch
from torch import nn

from ..core import constants as C


@torch.no_grad()
def _extract(model: nn.Module, wavs: np.ndarray, batch: int) -> np.ndarray:
    outs = []
    for s in range(0, len(wavs), batch):
        x = torch.as_tensor(wavs[s:s + batch].astype(np.float32),
                            device=model.device)
        outs.append(model(x).cpu().numpy())
    return np.concatenate(outs)


def extract_wavlm(model: nn.Module, wavs: np.ndarray,
                  batch: int = 8) -> np.ndarray:
    """Step 3: WavLM features per window, (n, 199, D) float32 for 4 s
    windows."""
    return _extract(model, wavs, batch)


def extract_wavvq(model: nn.Module, wavs: np.ndarray,
                  batch: int = 8) -> np.ndarray:
    """Step 4: vq-wav2vec codes per window, (n, 398, 2) int32."""
    return _extract(model, wavs, batch).astype(np.int32)


def window_test_audio(wav: np.ndarray, n_frames: int = 240, fps: int = C.FPS,
                      sr: int = C.SR) -> np.ndarray:
    """Test-audio windowing (make_test_data.py:18-33): (n, 64000)."""
    minlen = len(wav) / sr * fps
    n_sub = math.floor((minlen - n_frames) / n_frames) + 1
    alen = int(n_frames / fps * sr)
    if n_sub < 1:
        raise ValueError(
            f"audio too short: {len(wav)} samples ({len(wav) / sr:.2f} s) "
            f"< one {n_frames}-frame window ({alen} samples, "
            f"{n_frames / fps:.1f} s at {fps} fps)")
    return np.stack([wav[math.floor(i * n_frames / fps * sr):
                         math.floor(i * n_frames / fps * sr) + alen]
                     for i in range(n_sub)]).astype(np.float32)


def hashed_embed_fn(dim: int = C.CONTEXT_DIM):
    """Deterministic stand-in embedding (bag of hashed words, L2
    normalized) for tests and offline runs. Uses crc32, not Python's
    hash(), which is salted per process."""

    def embed(texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), dim), np.float32)
        for i, text in enumerate(texts):
            for w in text.split():
                h = zlib.crc32(w.encode("utf-8"))
                out[i, h % dim] += 1.0
            n = np.linalg.norm(out[i])
            if n > 0:
                out[i] /= n
        return out

    return embed
