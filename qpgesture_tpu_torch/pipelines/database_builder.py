"""The database-builder helpers of the raw-wav ``generate`` path.

The port of part of ``qpgesture_tpu/pipelines/database_builder.py``: test
audio windowing (make_test_data.py:18-33), feature extraction with the
port's encoders (wav_to_wavlm, make_beat_dataset.py:337-385; wav_to_vq,
:388-429), the word -> code-slot bucketing of the transcript context
(``context_slots``) and the sentence embeddings (``minilm_embed_fn``, and
the hashed stand-in). The rest of the builder is still to be ported.
"""
from __future__ import annotations

import math
import zlib
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..core import constants as C
from ..device import DeviceLike


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


def context_slots(words: List[Tuple[float, float, str]], start_time: float,
                  end_time: float, stride_time: int = 4,
                  num_codes: int = C.NUM_FRAMES_CODE,
                  step_sz: int = 8) -> List[str]:
    """Word -> code-slot bucketing (make_txt_dataset, make_beat_dataset.py:
    548-565): a word lands in the slot of its within-window midpoint; each
    code's context is the join of words within +-3 slots."""
    slots: List[List[str]] = [[] for _ in range(num_codes)]
    for (s, e, w) in words:
        if not (start_time <= (s + e) / 2 < end_time):
            continue
        e_mod = e % stride_time if e % stride_time != 0 else stride_time
        idx = int((s % stride_time + e_mod) * 60 / 2 / step_sz)
        slots[min(idx, num_codes - 1)].append(w)
    out = []
    for j in range(num_codes):
        lo = max(j - 3, 0)
        hi = min(j + 4, num_codes)
        out.append(" ".join(w for sl in slots[lo:hi] for w in sl))
    return out


def minilm_embed_fn(checkpoint_dir: str, device: DeviceLike = "cuda"):
    """MiniLM sentence embeddings on the device: the reference's
    paraphrase-MiniLM-L6-v2 stack (make_beat_dataset.py:446-447) as
    models/minilm.py runs it (host WordPiece, BERT encoder and mean pooling
    on `device`). Needs the checkpoint directory (config.json + vocab.txt
    + weights); returns texts -> (n, 384)."""
    from ..models.minilm import load_minilm
    return load_minilm(checkpoint_dir, device=device)


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
