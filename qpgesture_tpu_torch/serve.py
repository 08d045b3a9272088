"""Serving pipeline: staged audio/context in, decoded poses out.

Production path for "generate gestures for this wav" on host-staged
features: the CodeKNN match and the VQ-VAE decode run back to back on the
device, with one upload of the queries and one download of codes and
poses per request.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .device import resolve_device
from .match.engine import CodeKNNEngine, _predict_impl
from .models.vqvae import VQVAE
from .render.decode import denormalize


@dataclass
class ServingPipeline:
    """Bind a matching engine and a VQ-VAE on one device; serve clips end
    to end."""
    engine: CodeKNNEngine
    model: VQVAE
    data_mean: Optional[np.ndarray] = None
    data_std: Optional[np.ndarray] = None

    def __post_init__(self):
        if resolve_device(self.model.device) != self.engine.device:
            raise ValueError(f"engine on {self.engine.device}, model on "
                             f"{self.model.device}: serve from one device")

    @torch.no_grad()
    def serve(self, test_audio: Optional[np.ndarray],
              test_context: Optional[np.ndarray] = None,
              init_code: int = 0,
              init_phase: Optional[np.ndarray] = None,
              rng: Optional[np.random.RandomState] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """One clip -> (codes (W, 30), poses (W*240, 135) denormalized).

        The clip starts from init_code (0) and init_phase (zeros) — unlike
        CodeKNNEngine.predict, which draws its initial seed from the rng.
        Rand bits (no-phase aud+txt vote) and per-window re-seeds
        (non-chaining configs) come from engine._chain_inputs with the same
        rng as predict."""
        engine = self.engine
        cfg = engine.cfg
        rng = rng or np.random.RandomState(cfg.seed)
        lead = test_audio if test_audio is not None else test_context
        W, S = lead.shape[:2]
        if init_phase is None:
            init_phase = np.zeros((8, 16), np.float32)
        Q = W * S
        rand_np, (rmask, rcode, rphase) = engine._chain_inputs(W, S, rng)
        if rmask is None:
            rmask = np.zeros((Q,), bool)
            rcode = np.zeros((Q,), np.int32)
            rphase = np.zeros((Q, 8, 16), np.float32)
        rmask = rmask.copy(); rcode = rcode.copy(); rphase = rphase.copy()
        rmask[0] = True
        rcode[0] = init_code
        rphase[0] = init_phase

        ta, tc = engine.stage_queries(test_audio, test_context)
        blocks, _, _ = _predict_impl(cfg, S, engine.dev, engine.devdb, ta,
                                     tc, init_code, init_phase, rand_np,
                                     rmask, rcode, rphase)
        codes = blocks.reshape(W, S * cfg.step_sz)[:, :cfg.num_frames_code]
        # decode the flattened code string in one pass (window-boundary
        # smoothness through the decoder's receptive field,
        # VisualizeCodebook.py:139-146)
        poses = self.model.decode(codes.reshape(1, -1))[0]
        codes_np = codes.to(torch.int32).cpu().numpy()
        poses_np = poses.cpu().numpy()
        return codes_np, denormalize(poses_np, self.data_mean, self.data_std)
