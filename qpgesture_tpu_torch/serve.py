"""Serving: a clip in, decoded poses out.

Production path for "generate gestures for this wav". Two servers share
one tail (the CodeKNN match and the VQ-VAE decode, back to back on the
device, one download of codes and poses per request):

  * ServingPipeline takes host-staged queries (``stage_test_audio`` and
    ``stage_test_context`` output);
  * RawWavServer takes the raw 16 kHz windows: the audio encoder (WavLM or
    vq-wav2vec) and the per-step staging run on the device too, so a
    request uploads only the wav (int16 accepted) and the context.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .match.device_staging import stage_context, stage_wavlm, stage_wavvq
from .match.engine import CodeKNNEngine, _predict_impl
from .models.vqvae import VQVAE
from .render.decode import denormalize


def _check_same_device(engine: CodeKNNEngine, **modules) -> None:
    for name, m in modules.items():
        if resolve_device(m.device) != engine.device:
            raise ValueError(f"engine on {engine.device}, {name} on "
                             f"{m.device}: serve from one device")


@torch.no_grad()
def _serve_staged(engine: CodeKNNEngine, model: VQVAE, ta, tc, W: int,
                  S: int, init_code: int, init_phase: Optional[np.ndarray],
                  rng: Optional[np.random.RandomState], data_mean,
                  data_std) -> Tuple[np.ndarray, np.ndarray]:
    """Device queries of one clip -> (codes (W, 30), poses (W*240, 135)
    denormalized).

    The clip starts from init_code and init_phase (zeros), unlike
    CodeKNNEngine.predict, which draws its initial seed from the rng. Rand
    bits (no-phase aud+txt vote) and per-window re-seeds (non-chaining
    configs) come from engine._chain_inputs with the same rng as predict."""
    cfg = engine.cfg
    rng = rng or np.random.RandomState(cfg.seed)
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

    blocks, _, _ = _predict_impl(cfg, S, engine.dev, engine.devdb, ta, tc,
                                 init_code, init_phase, rand_np, rmask,
                                 rcode, rphase)
    codes = blocks.reshape(W, S * cfg.step_sz)[:, :cfg.num_frames_code]
    # decode the flattened code string in one pass (window-boundary
    # smoothness through the decoder's receptive field,
    # VisualizeCodebook.py:139-146)
    poses = model.decode(codes.reshape(1, -1))[0]
    codes_np = codes.to(torch.int32).cpu().numpy()
    return codes_np, denormalize(poses.cpu().numpy(), data_mean, data_std)


@dataclass
class ServingPipeline:
    """Bind a matching engine and a VQ-VAE on one device; serve host-staged
    clips end to end."""
    engine: CodeKNNEngine
    model: VQVAE
    data_mean: Optional[np.ndarray] = None
    data_std: Optional[np.ndarray] = None

    def __post_init__(self):
        _check_same_device(self.engine, model=self.model)

    def serve(self, test_audio: Optional[np.ndarray],
              test_context: Optional[np.ndarray] = None,
              init_code: int = 0,
              init_phase: Optional[np.ndarray] = None,
              rng: Optional[np.random.RandomState] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """One clip of staged queries -> (codes (W, 30), poses (W*240,
        135) denormalized); see _serve_staged for the seeds."""
        lead = test_audio if test_audio is not None else test_context
        W, S = lead.shape[:2]
        ta, tc = self.engine.stage_queries(test_audio, test_context)
        return _serve_staged(self.engine, self.model, ta, tc, W, S,
                             init_code, init_phase, rng, self.data_mean,
                             self.data_std)


@dataclass
class RawWavServer:
    """Raw 16 kHz windows in, decoded poses out, the whole ingress on the
    device.

    ``encoder`` is the audio encoder on the engine's device: a WavLM
    (models/wavlm.py) returning features (W, F, D) for the wavlm modes, or
    a VQWav2Vec (models/vq_wav2vec.py) returning codes (W, 398, 2) for the
    wavvq mode. Context embeddings stay a host input: they come from the
    transcript, not the audio. Selected codes equal those of encoding the
    same windows, staging on the host and serving the staged queries
    (tests/test_torch_rawwav.py)."""
    engine: CodeKNNEngine
    model: VQVAE
    encoder: nn.Module
    data_mean: Optional[np.ndarray] = None
    data_std: Optional[np.ndarray] = None

    def __post_init__(self):
        cfg = self.engine.cfg
        if not cfg.use_aud:
            raise ValueError("RawWavServer is the audio ingress path; the "
                             "config does not use audio")
        if cfg.audio_mode not in ("wavvq_feat", "wavlm_feat", "wavlm"):
            raise ValueError(
                f"RawWavServer handles the wavvq/wavlm ingress; mode "
                f"{cfg.audio_mode!r} stages MFCC features on host "
                f"(use ServingPipeline with stage_test_audio)")
        _check_same_device(self.engine, model=self.model,
                           encoder=self.encoder)
        self.n_steps = len(self.engine.db.geom.step_clip_idx)

    @torch.no_grad()
    def encode(self, wav: np.ndarray) -> torch.Tensor:
        """(W, n_samples) int16 or float windows -> the encoder's output on
        the device. int16 arrives as int16 and becomes wav / 32768 there."""
        x = torch.as_tensor(np.asarray(wav), device=self.engine.device)
        x = x.float() / 32768.0 if not x.is_floating_point() else x.float()
        return self.encoder(x)

    def stage(self, enc: torch.Tensor,
              test_context: Optional[np.ndarray]):
        """Encoder output (+ host context) -> device queries (ta, tc)."""
        cfg = self.engine.cfg
        geom = self.engine.db.geom
        if cfg.audio_mode == "wavvq_feat":
            ta = stage_wavvq(cfg, geom, enc)
        else:
            ta = stage_wavlm(cfg, geom, enc)
        tc = None
        if cfg.use_txt:
            tc = stage_context(geom, torch.as_tensor(
                test_context, device=self.engine.device))
        return ta, tc

    def serve(self, wav: np.ndarray,
              test_context: Optional[np.ndarray] = None,
              init_code: int = 0,
              init_phase: Optional[np.ndarray] = None,
              rng: Optional[np.random.RandomState] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """wav (W, n_samples) int16/float windows (+ (W, 30, 384) context
        when the config uses text) -> (codes (W, 30), poses (W*240, 135)
        denormalized); see _serve_staged for the seeds."""
        ta, tc = self.stage(self.encode(wav), test_context)
        return _serve_staged(self.engine, self.model, ta, tc, wav.shape[0],
                             self.n_steps, init_code, init_phase, rng,
                             self.data_mean, self.data_std)

    def serve_batch(self, *args, **kwargs):
        raise NotImplementedError(
            "RawWavServer.serve_batch is not ported yet: it waits for "
            "CodeKNNEngine.predict_batch")

    def serve_sharded(self, *args, **kwargs):
        raise NotImplementedError(
            "RawWavServer.serve_sharded is not ported yet: it waits for "
            "the multi-GPU matching path")
