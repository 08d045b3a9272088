"""Readers/writers for the npz artifact formats shared with the reference.

Exact key layouts:
  * database bundle ``{prefix}_{split}_240_txt_2.npz``: body/mfcc/wav/txt/aux/
    energy/pitch/volume/context/phase (make_beat_dataset.py:569-573)
  * codes ``*_code.npz``: code (n, 30)        (make_beat_dataset.py:261-325)
  * WavLM ``*_WavLM.npz``: wavlm (n, 199, 1024) (make_beat_dataset.py:337-385)
  * wavvq ``*_WavVQ.npz`` / ``wavvq_240.npz``: wavvq (n, 398, 2) int codes
    (make_test_data.py:64)
  * signatures ``code.npz``: code (512, 30), poses (512, 240, 135),
    signature (512, 135) (VisualizeCodebook.py:116)
  * result ``result.npz``: knn_pred (n, 30)   (GestureKNN.py:845)

One deliberate improvement: the reference stores PAE phases as object-dtype
arrays of pickled torch tensors, needing allow_pickle plus a repair script
(process/fix_device_bug.py). This framework normalizes phase to a dense
float32 ``(n, T, 4, 8)`` array — [phase, freq, amplitude, offset] x 8 channels
— and converts legacy object arrays on load.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


def _to_dense_phase(phase: np.ndarray) -> np.ndarray:
    """Convert phase arrays to dense float32 (n, T, 4, 8).

    Accepts either the dense layout or the reference's object-dtype layout
    where each cell is a (1, 8, 1)-shaped array/tensor
    (data_processing.py:339-340, PAE.py:504-508).
    """
    if phase.dtype != object:
        phase = np.asarray(phase, dtype=np.float32)
        if phase.ndim == 4 and phase.shape[2] == 4 and phase.shape[3] == 8:
            return phase
        if phase.ndim == 5:  # (n, T, 4, 8, 1) or (n, T, 4, 1, 8)
            return phase.reshape(phase.shape[:3] + (8,)).astype(np.float32)
        raise ValueError(f"unrecognized dense phase shape {phase.shape}")

    def cell(x):
        if hasattr(x, "detach"):  # torch tensor
            x = x.detach().cpu().numpy()
        return np.asarray(x, dtype=np.float32).reshape(-1)

    n, t = phase.shape[0], phase.shape[1]
    out = np.zeros((n, t, 4, 8), dtype=np.float32)
    for i in range(n):
        for j in range(t):
            for p in range(4):
                out[i, j, p] = cell(phase[i, j][p] if phase[i, j].ndim else
                                    phase[i, j, p])
    return out


@dataclass
class DatabaseBundle:
    """One split of a speaker database (the ``*_txt_2.npz`` schema)."""
    body: Optional[np.ndarray] = None      # (n, 240, 135)
    mfcc: Optional[np.ndarray] = None      # (n, 240, >=13)
    wav: Optional[np.ndarray] = None       # (n, 64000)
    energy: Optional[np.ndarray] = None    # (n, 240)
    pitch: Optional[np.ndarray] = None     # (n, 240)
    volume: Optional[np.ndarray] = None    # (n, 240)
    context: Optional[np.ndarray] = None   # (n, 30, 1, 384) or (n, 30, 384)
    phase: Optional[np.ndarray] = None     # dense (n, T, 4, 8)
    txt: Optional[np.ndarray] = None
    aux: Optional[np.ndarray] = None

    @classmethod
    def load(cls, path: str) -> "DatabaseBundle":
        data = np.load(path, allow_pickle=True)
        kwargs: Dict[str, np.ndarray] = {}
        for f in dataclasses.fields(cls):
            if f.name in data.files:
                arr = data[f.name]
                if f.name == "phase":
                    arr = _to_dense_phase(arr)
                kwargs[f.name] = arr
        return cls(**kwargs)

    def save(self, path: str) -> None:
        arrays = {f.name: getattr(self, f.name) for f in
                  dataclasses.fields(self) if getattr(self, f.name) is not None}
        np.savez_compressed(path, **arrays)

    @property
    def context_2d(self) -> np.ndarray:
        """Context as (n, 30, 384), squeezing the reference's extra dim
        (data_processing.py:342-343)."""
        ctx = self.context
        if ctx.ndim == 4:
            ctx = ctx.squeeze(2)
        return ctx


def load_codes(path: str) -> np.ndarray:
    """(n, 30) int codebook indices."""
    return np.load(path)["code"]


def save_codes(path: str, code: np.ndarray) -> None:
    np.savez_compressed(path, code=code)


def load_wavlm(path: str) -> np.ndarray:
    """(n, 199, 1024) WavLM-Large last-layer features."""
    return np.load(path)["wavlm"]


def save_wavlm(path: str, wavlm: np.ndarray) -> None:
    np.savez_compressed(path, wavlm=wavlm)


def load_wavvq(path: str) -> np.ndarray:
    """(n, 398, 2) vq-wav2vec Gumbel code indices."""
    return np.load(path)["wavvq"]


def save_wavvq(path: str, wavvq: np.ndarray) -> None:
    np.savez_compressed(path, wavvq=wavvq)


@dataclass
class CodebookSignature:
    """The code.npz artifact consumed by the matching engine
    (VisualizeCodebook.py:116: decode each code as a constant 30-code block;
    signature = mean decoded pose over time)."""
    code: np.ndarray       # (512, 30)
    poses: np.ndarray      # (512, 240, 135)
    signature: np.ndarray  # (512, 135)

    @classmethod
    def load(cls, path: str) -> "CodebookSignature":
        data = np.load(path)
        return cls(code=data["code"], poses=data["poses"],
                   signature=data["signature"])

    def save(self, path: str) -> None:
        np.savez_compressed(path, code=self.code, poses=self.poses,
                            signature=self.signature)


def load_result(path: str) -> np.ndarray:
    """(n, 30) predicted code indices."""
    return np.load(path)["knn_pred"]


def save_result(path: str, knn_pred: np.ndarray) -> None:
    np.savez_compressed(path, knn_pred=knn_pred)
