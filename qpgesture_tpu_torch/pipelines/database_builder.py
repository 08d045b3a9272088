"""Speaker database construction (make_beat_dataset steps 1-4 equivalents).

The port of ``qpgesture_tpu/pipelines/database_builder.py``. Builds, from
raw (BVH, wav, transcript) recordings, every artifact the matching engine
consumes:

  step 2 (process/make_beat_dataset.py:99-258): 60 fps rotation-matrix
    extraction through the motion pipeline, 16 kHz audio, Sphinx MFCC,
    prosody (energy/pitch/volume interpolated to 60 fps), non-overlapping
    240-frame windows split by filename rule ('103'->test, '111'->valid,
    skip '81_86') -- host NumPy, bit-equal to the JAX package;
  step 3 (:261-385): VQ-VAE codes per window and WavLM features per window,
    with the port's models on their device;
  step 4 (:388-580): vq-wav2vec codes; word->code-slot bucketing (+-3
    slots) and sentence embeddings -> the *_txt bundle, with dense PAE
    phases (models/pae.PhaseExtractor).

Also the test-audio windowing of the ``generate`` path
(make_test_data.py:18-33). Sentence embeddings come from a caller-provided
embed_fn: ``minilm_embed_fn`` (the port's MiniLM), the host-torch
``sentence_transformer_embed_fn``, or the hashed stand-in.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core import constants as C
from ..core.schemas import DatabaseBundle
from ..device import DeviceLike
from ..motion.bvh import BVHData
from ..motion.pipeline import MotionPipeline
from ..motion.rotations import poses_to_matrices
from ..ops.logmel import N_SAMPLES
from ..ops.mfcc import MFCCConfig, sphinx_mfcc_np
from .audio_host import cal_volume, get_energy, interp_to_fps
from .pitch_world import get_pitch_world


def split_of(name: str) -> Optional[str]:
    """Filename split rule (make_beat_dataset.py:207-213)."""
    if "81_86" in name:
        return None
    if "103" in name:
        return "test"
    if "111" in name:
        return "validation"
    return "train"


@dataclass
class Recording:
    """One processed recording (the per-file outputs of step 2)."""
    name: str
    rotation: np.ndarray          # (T, 135) rotation-matrix poses @ 60 fps
    rotation_mirror: np.ndarray   # (T, 135)
    wav: np.ndarray               # (S,) float 16 kHz
    mfcc: np.ndarray              # (T_mfcc, 13)
    energy: np.ndarray            # (T,) interpolated to 60 fps
    pitch: np.ndarray             # (T,)
    volume: np.ndarray            # (T,)
    words: List[Tuple[float, float, str]] = field(default_factory=list)
    phase: Optional[np.ndarray] = None  # (T, 4, 8) dense PAE phases


def process_recording(name: str, bvh: BVHData, wav: np.ndarray,
                      pipeline: MotionPipeline,
                      words: Optional[List[Tuple[float, float, str]]] = None,
                      fps: int = C.FPS, sr: int = C.SR) -> Recording:
    """Step-2 per-recording processing (host)."""
    euler = pipeline.transform(bvh)
    euler_mirror = pipeline.transform(bvh, mirror=True)
    rotation = poses_to_matrices(euler).astype(np.float32)
    rotation_mirror = poses_to_matrices(euler_mirror).astype(np.float32)
    T = rotation.shape[0]

    mfcc = sphinx_mfcc_np(wav, MFCCConfig(frate=fps)).astype(np.float32)
    energy = interp_to_fps(get_energy(wav, sr=sr), T).astype(np.float32)
    # WORLD dio+stonemask pitch with the reference's exact flags
    # (make_beat_dataset.py:170: log=True, norm=False)
    pitch = interp_to_fps(
        get_pitch_world(wav, sr=sr, log=True, norm=False), T
    ).astype(np.float32)
    wav16 = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
    volume = interp_to_fps(cal_volume(wav16), T).astype(np.float32)
    return Recording(name=name, rotation=rotation,
                     rotation_mirror=rotation_mirror,
                     wav=wav.astype(np.float32), mfcc=mfcc, energy=energy,
                     pitch=pitch, volume=volume, words=words or [])


def window_recordings(recordings: Sequence[Recording], n_frames: int = 240,
                      stride: Optional[int] = None, fps: int = C.FPS,
                      sr: int = C.SR,
                      embed_fn: Optional[Callable[[List[str]], np.ndarray]]
                      = None, include_mirror: bool = False
                      ) -> DatabaseBundle:
    """Non-overlapping (or strided) 240-frame windows -> DatabaseBundle."""
    stride = stride or n_frames
    if include_mirror and any(rec.phase is not None for rec in recordings):
        # mirrored windows carry no phase, so bundle.phase would be shorter
        # than bundle.body and staging would pair motions with the wrong
        # phase rows
        raise ValueError(
            "include_mirror=True with phase-extracted recordings would "
            "misalign phase with body windows; run the PAE over the "
            "mirrored rotations too, or build the mirrored (training) "
            "bundle without phase")
    body, mfcc_w, wav_w, energy_w, pitch_w, volume_w = [], [], [], [], [], []
    phase_w, ctx_w, aux = [], [], []
    for rec in recordings:
        sources = [(rec.rotation, rec.phase)]
        if include_mirror:
            sources.append((rec.rotation_mirror, None))
        for rotation, phase in sources:
            minlen = min(len(rotation), len(rec.mfcc))
            n_sub = math.floor((minlen - n_frames) / stride) + 1
            alen = int(n_frames / fps * sr)
            for i in range(n_sub):
                s = i * stride
                f = s + n_frames
                body.append(rotation[s:f])
                mfcc_w.append(rec.mfcc[s:f])
                a0 = math.floor(s / fps * sr)
                seg = rec.wav[a0:a0 + alen]
                if len(seg) < alen:
                    seg = np.pad(seg, (0, alen - len(seg)))
                wav_w.append(seg)
                energy_w.append(rec.energy[s:f])
                pitch_w.append(rec.pitch[s:f])
                volume_w.append(rec.volume[s:f])
                if phase is not None:
                    phase_w.append(phase[s:f])
                if embed_fn is not None:
                    texts = context_slots(rec.words, s / fps, f / fps)
                    ctx_w.append(embed_fn(texts)[:, None, :])
                aux.append([rec.name, s / fps, f / fps])
    return DatabaseBundle(
        body=np.asarray(body, np.float32),
        mfcc=np.asarray(mfcc_w, np.float32),
        wav=np.asarray(wav_w, np.float32),
        energy=np.asarray(energy_w, np.float32),
        pitch=np.asarray(pitch_w, np.float32),
        volume=np.asarray(volume_w, np.float32),
        phase=np.asarray(phase_w, np.float32) if phase_w else None,
        context=np.asarray(ctx_w, np.float32) if ctx_w else None,
        aux=np.asarray(aux, object))


@torch.no_grad()
def encode_windows(model: nn.Module, body: np.ndarray,
                   data_mean: np.ndarray, data_std: np.ndarray,
                   batch: int = 64) -> np.ndarray:
    """Step 3: VQ-VAE-encode normalized windows on the model's device ->
    (n, 30) int32 codes (dataset_to_code, make_beat_dataset.py:261-325)."""
    std = np.clip(data_std, 0.01, None)
    norm = (body - data_mean) / std
    outs = []
    for s in range(0, len(norm), batch):
        x = torch.as_tensor(norm[s:s + batch].astype(np.float32),
                            device=model.device)
        outs.append(model.encode(x).cpu().numpy())
    return np.concatenate(outs).astype(np.int32)


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


def extract_utterances(model: nn.Module, wavs: np.ndarray,
                       recordings: Optional[Sequence[str]] = None
                       ) -> np.ndarray:
    """Features of consecutive windows from an encoder that takes
    utterances (Whisper): the windows in runs of as many as one utterance
    holds (7 of 4 s in 30 s), each run one utterance; (n, 200, D) float32
    for 4 s windows. ``recordings`` names each window's recording (a
    bundle's ``aux[:, 0]``): a run then never crosses from one recording to
    the next, so a database's windows are encoded as a query's are. None:
    all windows are one recording."""
    per = N_SAMPLES // wavs.shape[1]
    names = [None] * len(wavs) if recordings is None else list(recordings)
    edges = [i for i in range(1, len(wavs)) if names[i] != names[i - 1]]
    outs = []
    with torch.no_grad():
        for a, b in zip([0] + edges, edges + [len(wavs)]):
            for s in range(a, b, per):
                x = torch.as_tensor(wavs[s:min(s + per, b)].astype(
                    np.float32), device=model.device)
                outs.append(model(x, clips=1).cpu().numpy())
    return np.concatenate(outs)


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


def sentence_transformer_embed_fn(model_name_or_path: str =
                                  "paraphrase-MiniLM-L6-v2",
                                  device: str = "cpu"):
    """The reference's embedding model (make_beat_dataset.py:446-447) via
    host torch, kept as the verification oracle for ``minilm_embed_fn``.
    Nothing is downloaded here (``local_files_only``): a model name
    resolves only through the local cache, and a machine without the
    packages raises ImportError.

    Prefers the sentence-transformers package; falls back to a plain
    ``transformers`` implementation of the same module stack (the
    paraphrase-MiniLM-* models are Transformer + mean pooling with no output
    normalization)."""
    try:
        from sentence_transformers import SentenceTransformer
        model = SentenceTransformer(model_name_or_path, device=device,
                                    local_files_only=True)

        def embed(texts: List[str]) -> np.ndarray:
            return np.asarray(model.encode(texts))

        return embed
    except ImportError:
        return transformers_mean_pool_embed_fn(model_name_or_path, device)


def transformers_mean_pool_embed_fn(model_name_or_path: str,
                                    device: str = "cpu"):
    """Mean-pooled AutoModel embeddings (the sentence-transformers
    'Transformer + Pooling(mean)' stack without the package)."""
    from transformers import AutoModel, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_name_or_path,
                                        local_files_only=True)
    model = AutoModel.from_pretrained(model_name_or_path,
                                      local_files_only=True).to(device).eval()

    def embed(texts: List[str]) -> np.ndarray:
        with torch.no_grad():
            enc = tok(texts, padding=True, truncation=True, max_length=128,
                      return_tensors="pt").to(device)
            hidden = model(**enc).last_hidden_state          # (B, L, H)
            mask = enc["attention_mask"].unsqueeze(-1).to(hidden.dtype)
            emb = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
        return emb.cpu().numpy()

    return embed


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
