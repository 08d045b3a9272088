"""Device-side test-query staging: the encoders' outputs become per-step
queries without leaving the device.

The port of ``qpgesture_tpu/match/device_staging.py``. Each function
repeats the host staging of ``match/database.py`` (``stage_test_audio``,
``stage_test_context``) as torch gathers on the device of its input, with
the index tables computed on the host from the static ModeGeometry:

  * the integer gathers (wavvq strings, frame selection, context slots) are
    bit-exact;
  * the WavLM interpolation uses the host's float32 weights and its
    multiply-then-add order, as separate elementwise operations, so it
    matches the host too (the JAX version admits 1 ulp because XLA fuses
    the lerp into an FMA).

Reference staging semantics: data_processing.py:208-335 (stacks),
:258-261 (interpolate), GestureKNN.py:549-551 (context slots).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import constants as C
from ..core.config import MatchConfig
from ..device import to_device
from .geometry import ModeGeometry


def interp_coeffs(T: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static (lo, w) for linear interpolation T -> size frames, matching
    ops/stacking.interpolate_linear (torch F.interpolate align_corners=True):
    out[t] = x[lo[t]] * (1 - w[t]) + x[lo[t] + 1] * w[t]."""
    coords = np.arange(size, dtype=np.float64) * (T - 1) / (size - 1)
    lo = np.clip(np.floor(coords).astype(np.int64), 0, T - 2)
    w = (coords - lo).astype(np.float32)
    return lo, w


def _index(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return to_device(np.asarray(x, np.int64), device)


def _interpolate(x: torch.Tensor, size: int) -> torch.Tensor:
    """(W, T, F) -> (W, size, F) with the host interpolation's float32
    weights and operation order."""
    T = x.shape[1]
    if size == T:
        return x
    lo, w = interp_coeffs(T, size)
    one_minus = to_device(np.float32(1.0) - w, x.device)
    w = to_device(w, x.device)
    lo = _index(lo, x.device)
    return (x[:, lo] * one_minus[None, :, None]
            + x[:, lo + 1] * w[None, :, None])


def _gather_steps(x: torch.Tensor, idx: np.ndarray,
                  valid: np.ndarray) -> torch.Tensor:
    """x (W, T, ...) -> x[:, idx] (W, S, k, ...), zero where not valid."""
    n = x.shape[1]
    sel = x[:, _index(np.clip(idx, 0, n - 1), x.device)]
    mask = to_device(valid, x.device)
    return torch.where(mask.view(1, *mask.shape, *([1] * (sel.dim() - 3))),
                       sel, 0)


def stage_wavlm(cfg: MatchConfig, geom: ModeGeometry,
                feats: torch.Tensor) -> torch.Tensor:
    """WavLM features (W, 199, 1024) -> per-step queries.

    wavlm_feat: interpolate to geom.n_db_frm, 6-frame stride-2 context
    stack, select step frames -> (W, S, 6144). wavlm (raw): step_sz
    consecutive interpolated frames per step -> (W, S, step*1024)."""
    interp = _interpolate(feats.float(), geom.n_db_frm)
    sidx = geom.step_clip_idx
    if cfg.audio_mode == "wavlm_feat":
        offs = np.arange(C.NUM_AUDIO_FEAT_FRAMES) * (C.FRAME_INTERVAL - 2)
        idx = sidx[:, None] + offs[None, :]                   # (S, 6)
    else:
        idx = sidx[:, None] + np.arange(int(geom.step_sz))[None, :]
    sel = _gather_steps(interp, idx, idx < geom.n_db_frm)     # stack_post pad
    return sel.reshape(sel.shape[0], len(sidx), -1)


def wavvq_shifts(T: int, n_stack: int = 6,
                 num_frames_code: int = C.NUM_FRAMES_CODE) -> np.ndarray:
    """The 11 two-sided stacking shifts of ops/stacking.stack_wavvq: frame t
    slot s reads codes[t + shifts[s]] (zero where out of range)."""
    fi = T / num_frames_code
    past = [-int((n_stack - 1 - i) * fi) for i in range(n_stack)]
    future = [int(j * fi) for j in range(1, n_stack)]
    return np.array(past + future, dtype=np.int64)


def stage_wavvq(cfg: MatchConfig, geom: ModeGeometry,
                codes: torch.Tensor) -> torch.Tensor:
    """vq-wav2vec codes (W, 398, 2) int -> per-step query strings:
    (W, S, 11) combined symbols g0*320+g1 ('combine') or (W, S, 2, 11)
    per-group strings ('sum'), int32."""
    T = codes.shape[1]
    idx = geom.step_clip_idx[:, None] + wavvq_shifts(T)[None, :]  # (S, 11)
    sel = _gather_steps(codes.to(torch.int32), idx,
                        (idx >= 0) & (idx < T))               # (W, S, 11, 2)
    if cfg.wavvq_mode == "sum":
        return sel.transpose(-1, -2).contiguous()             # (W, S, 2, 11)
    return sel[..., 0] * C.WAVVQ_VOCAB + sel[..., 1]


def stage_context(geom: ModeGeometry,
                  context: torch.Tensor) -> torch.Tensor:
    """(W, 30, 384) context embeddings -> (W, S, 384) per-step queries
    (stage_test_context's static slot gather)."""
    ctx = context.float()
    if ctx.dim() == 4:
        ctx = ctx.squeeze(2)
    return ctx[:, _index(geom.step_context_idx, ctx.device)]
