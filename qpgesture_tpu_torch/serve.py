"""Serving: clips in, decoded poses out.

Production path for "generate gestures for this wav". Every surface ends
in the same tail, the CodeKNN match and the VQ-VAE decode back to back on
the device with one download of codes and poses:

  * ServingPipeline takes host-staged queries (``stage_test_audio`` and
    ``stage_test_context`` output);
  * RawWavServer takes the raw 16 kHz windows: the audio encoder (WavLM or
    vq-wav2vec) and the per-step staging run on the device too, so a
    request uploads only the wav (int16 accepted) and the context.
    ``serve_batch`` runs C clips at once: C*W windows through the encoder
    as one batch, the clips as C lanes of one fusion scan, one decode;
  * the streaming classes take one window per call (StreamingSession,
    StreamingRawWavSession) or one window per stream for C streams
    (StreamingPool, StreamingRawWavPool); the seed code and phase of every
    stream stay on the device between calls;
  * TranscriptContextStager turns a transcript into the context input.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .device import resolve_device, to_device
from .match.device_staging import stage_context, stage_wavlm, stage_wavvq
from .match.engine import CodeKNNEngine, _solo_resets, check_codes
from .match.oracle import CodeKNNOracle
from .models.vqvae import VQVAE
from .pipelines.database_builder import context_slots
from .render.decode import denormalize
from .utils.profiling import count, span


def _check_same_device(engine: CodeKNNEngine, **modules) -> None:
    for name, m in modules.items():
        if resolve_device(m.device) != engine.device:
            raise ValueError(f"engine on {engine.device}, {name} on "
                             f"{m.device}: serve from one device")


def _root_counts(lanes: int, windows: int) -> None:
    """The counters of a request's root span: its lanes (clips or streams)
    and the windows of each."""
    count("lanes", lanes)
    count("windows", windows)


@torch.no_grad()
def _match_decode(engine: CodeKNNEngine, model: VQVAE, ta, tc, S: int,
                  C: int, rand_bits, resets, data_mean, data_std,
                  sharded: bool = False, group=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Device queries of C clips (C*W windows, clip-major) -> (codes (C, W,
    30), poses (C, W*240, 135) denormalized) host arrays. Each clip's code
    string decodes in one pass (window-boundary smoothness through the
    decoder's receptive field, VisualizeCodebook.py:139-146). sharded: phase
    1 over this rank's J-shard, combined across ``group``."""
    cfg = engine.cfg
    blocks, _, _ = engine.scan(engine.tables(ta, tc, sharded, group), S, C,
                               rand_bits, resets)
    codes = blocks.reshape(C, -1, S * cfg.step_sz)[..., :cfg.num_frames_code]
    with span("decode"):
        poses = model.decode(codes.reshape(C, -1))
    with span("fetch"):
        return (codes.to(torch.int32).cpu().numpy(),
                denormalize(poses.cpu().numpy(), data_mean, data_std))


def _serve_staged(engine: CodeKNNEngine, model: VQVAE, ta, tc, W: int,
                  S: int, init_code: int, init_phase: Optional[np.ndarray],
                  rng: Optional[np.random.RandomState], data_mean,
                  data_std, sharded: bool = False, group=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Device queries of one clip -> (codes (W, 30), poses (W*240, 135)
    denormalized).

    The clip starts from init_code and init_phase (zeros), unlike
    CodeKNNEngine.predict, which draws its initial seed from the rng. Rand
    bits (no-phase aud+txt vote) and per-window re-seeds (non-chaining
    configs) come from engine._chain_inputs with the same rng as predict."""
    rng = rng or np.random.RandomState(engine.cfg.seed)
    rand_np, reset = engine._chain_inputs(W, S, rng)
    codes, poses = _match_decode(
        engine, model, ta, tc, S, 1, rand_np,
        _solo_resets(W * S, init_code, init_phase, *reset), data_mean,
        data_std, sharded, group)
    return codes[0], poses[0]


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
        with span("serve"):
            _root_counts(1, W)
            ta, tc = self.engine.stage_queries(test_audio, test_context)
            return _serve_staged(self.engine, self.model, ta, tc, W, S,
                                 init_code, init_phase, rng, self.data_mean,
                                 self.data_std)


@dataclass
class RawWavServer:
    """Raw 16 kHz windows in, decoded poses out, the whole ingress on the
    device.

    ``encoder`` is the audio encoder on the engine's device: a 50 Hz
    feature encoder (WavLM, models/wavlm.py, or w2v-BERT,
    models/w2v_bert.py) returning features (W, 199, D) for the wavlm
    modes, or a VQWav2Vec (models/vq_wav2vec.py) returning codes (W, 398,
    2) for the wavvq mode. Context embeddings stay a host input: they come
    from the transcript (TranscriptContextStager), not the audio. Selected codes
    equal those of encoding the same windows, staging on the host and
    serving the staged queries (tests/test_torch_rawwav.py)."""
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
        """(W, n_samples) int16 or float windows (host array or tensor) ->
        the encoder's output on the device. int16 arrives as int16 and
        becomes wav / 32768 there."""
        with span("encode"):
            x = to_device(wav, self.engine.device)
            x = x.float() / 32768.0 if not x.is_floating_point() else x.float()
            return self.encoder(x)

    def stage(self, enc: torch.Tensor,
              test_context: Optional[np.ndarray]):
        """Encoder output (+ context, a host array or a tensor) -> device
        queries (ta, tc)."""
        cfg = self.engine.cfg
        geom = self.engine.db.geom
        with span("stage"):
            if cfg.audio_mode == "wavvq_feat":
                ta = stage_wavvq(cfg, geom, enc)
            else:
                ta = stage_wavlm(cfg, geom, enc)
            tc = None
            if cfg.use_txt:
                tc = stage_context(geom, to_device(test_context,
                                                   self.engine.device))
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
        with span("serve"):
            _root_counts(1, wav.shape[0])
            ta, tc = self.stage(self.encode(wav), test_context)
            return _serve_staged(self.engine, self.model, ta, tc,
                                 wav.shape[0], self.n_steps, init_code,
                                 init_phase, rng, self.data_mean,
                                 self.data_std)

    def serve_batch(self, wav: np.ndarray,
                    test_context: Optional[np.ndarray] = None,
                    init_codes: Optional[np.ndarray] = None,
                    init_phases: Optional[np.ndarray] = None,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """C clips at once: wav (C, W, n_samples) int16/float (+ (C, W, 30,
        384) context when the config uses text) -> (codes (C, W, 30), poses
        (C, W*240, 135) denormalized). The C*W windows go through the
        encoder as one batch, the clips run as C lanes of one fusion scan
        (CodeKNNEngine.predict_batch's seeds and rng order) and decode in
        one VQVAE.decode call. Per-clip codes equal serve() with the same
        explicit init codes."""
        cfg = self.engine.cfg
        C, W = wav.shape[:2]
        S = self.n_steps
        with span("serve_batch"):
            _root_counts(C, W)
            (_, _, reset_mask, reset_code, reset_phase,
             rand_bits) = self.engine._batch_inputs(
                C, W, S, None, None, init_codes, init_phases, rng)
            ctx = None
            if cfg.use_txt:
                ctx = np.asarray(test_context).reshape(
                    (C * W,) + test_context.shape[2:])
            ta, tc = self.stage(self.encode(wav.reshape((C * W,)
                                                        + wav.shape[2:])), ctx)
            return _match_decode(self.engine, self.model, ta, tc, S, C,
                                 rand_bits,
                                 (reset_mask, reset_code, reset_phase),
                                 self.data_mean, self.data_std)

    def serve_sharded(self, group, wav: np.ndarray,
                      test_context: Optional[np.ndarray] = None,
                      init_code: int = 0,
                      init_phase: Optional[np.ndarray] = None,
                      rng: Optional[np.random.RandomState] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """serve() with database-sharded matching over the process group
        ``group``: every rank runs the encoder and the device staging on the
        whole request, scores its J-shard of the database, and after the
        combine runs the fusion scan and the decode replicated. Same codes
        as serve() with the same rng, on every rank: the multi-GPU raw-wav
        surface for databases past one card's memory."""
        with span("serve"):
            _root_counts(1, wav.shape[0])
            ta, tc = self.stage(self.encode(wav), test_context)
            return _serve_staged(self.engine, self.model, ta, tc,
                                 wav.shape[0], self.n_steps, init_code,
                                 init_phase, rng, self.data_mean,
                                 self.data_std, sharded=True, group=group)


def _embed_unique(embed_fn, texts: List[str]) -> np.ndarray:
    """embed_fn over the distinct texts, each embedded once, gathered back
    in order."""
    uniq: dict = {}
    for t in texts:
        uniq.setdefault(t, len(uniq))
    emb = np.asarray(embed_fn(list(uniq)), np.float32)
    return emb[np.asarray([uniq[t] for t in texts], np.int64)]


class TranscriptContextStager:
    """Raw transcript in, per-window context embeddings out: the text
    counterpart of RawWavServer's audio ingress.

    The reference computes context embeddings offline with
    sentence-transformers (make_txt_dataset, make_beat_dataset.py:432-580:
    word -> code-slot bucketing at :548-565, MiniLM at :446-447). This
    stager runs the same pipeline at serve time: the host word -> slot
    bucketing (context_slots, the function the database builder uses) and
    ``embed_fn``, any texts -> (n, 384) callable; a
    ``models.minilm.MiniLMEncoder`` runs paraphrase-MiniLM-L6-v2 on the
    device. Identical slot texts (the +-3-slot joins repeat across
    neighbouring slots, silent stretches are all "") are embedded once per
    call."""

    def __init__(self, embed_fn, num_codes: int = 30,
                 window_sec: float = 4.0, stride_time: int = 4,
                 step_sz: int = 8):
        self.embed_fn = embed_fn
        self.num_codes = num_codes
        self.window_sec = window_sec
        self.stride_time = stride_time
        self.step_sz = step_sz

    def _slots(self, words, w: int) -> List[str]:
        return context_slots(words, w * self.window_sec,
                             (w + 1) * self.window_sec,
                             stride_time=self.stride_time,
                             num_codes=self.num_codes, step_sz=self.step_sz)

    def stage(self, words, n_windows: int) -> np.ndarray:
        """words: [(start_s, end_s, word), ...] -> (W, num_codes, D) float32
        context, the ``test_context`` of ServingPipeline.serve (through
        stage_test_context) and RawWavServer.serve."""
        texts = [t for w in range(n_windows) for t in self._slots(words, w)]
        return _embed_unique(self.embed_fn, texts).reshape(
            n_windows, self.num_codes, -1)

    def stage_window(self, words, window_index: int) -> np.ndarray:
        """One window for the streaming surfaces: -> (num_codes, D) float32
        context (the raw-wav sessions' context input for that window)."""
        return _embed_unique(self.embed_fn, self._slots(words, window_index))


def _pool_seeds(engine: CodeKNNEngine, n_streams: int, init_codes,
                init_phases, rngs) -> Tuple[np.ndarray, np.ndarray]:
    """Per-stream initial seeds, drawn exactly as a solo session draws
    them (the oracle's init_code_phase from each stream's own rng when not
    given), so pool streams are interchangeable with solo sessions."""
    oracle = CodeKNNOracle(engine.db)
    codes0 = np.zeros((n_streams,), np.int64)
    phases0 = np.zeros((n_streams, 8, 16), np.float32)
    for i in range(n_streams):
        ic = None if init_codes is None else init_codes[i]
        ip = None if init_phases is None else init_phases[i]
        if ic is None:
            ic, got = oracle.init_code_phase(rngs[i])
            if ip is None:
                ip = got
        codes0[i] = ic
        if ip is not None:
            phases0[i] = ip
    check_codes(codes0, engine.dev.sig_rank.shape[0], "init codes")
    return codes0, phases0


def _pool_reset_inputs(n_steps: int, codes: torch.Tensor,
                       phases: torch.Tensor):
    """Each lane's step-0 reset, fed from the carried per-stream seeds:
    the mask on the host, the codes and phases on the device (nothing
    comes back to the host)."""
    C = codes.shape[0]
    mask = np.zeros((C * n_steps,), bool)
    mask[::n_steps] = True
    rc = codes.new_zeros((C * n_steps,))
    rc[::n_steps] = codes
    rp = phases.new_zeros((C * n_steps, 8, 16))
    rp[::n_steps] = phases
    return mask, rc, rp


class _Streams:
    """Seed state of C live streams on the engine's device: codes (C,) and
    phases (C, 8, 16), advanced one window per stream per call by the
    lane-batched fusion scan. Chaining configs only: non-chaining modes
    (mfcc/raw presets) re-seed every window from host randomness, so there
    is no state to carry. The no-phase aud+txt vote mode draws each
    stream's per-step rand bits from that stream's own rng, as a solo
    session does."""

    def __init__(self, engine: CodeKNNEngine, n_streams: int, init_codes,
                 init_phases, rngs: Optional[list]):
        cfg = engine.cfg
        if not cfg.chain_windows:
            raise ValueError("streaming requires a window-chaining config; "
                             "non-chaining modes (mfcc/raw presets) re-seed "
                             "every window")
        self.engine = engine
        self.cfg = cfg
        self.n_streams = n_streams
        self.rngs = rngs or [np.random.RandomState(cfg.seed + i)
                             for i in range(n_streams)]
        if len(self.rngs) != n_streams:
            raise ValueError(f"{len(self.rngs)} rngs for {n_streams} streams")
        codes0, phases0 = _pool_seeds(engine, n_streams, init_codes,
                                      init_phases, self.rngs)
        self._codes_d = to_device(codes0, engine.device)
        self._phases_d = to_device(phases0, engine.device)
        self._needs_rand = (not cfg.use_phase and cfg.use_aud
                            and cfg.use_txt)

    def _active(self, active: Optional[np.ndarray]) -> np.ndarray:
        if active is None:
            return np.ones((self.n_streams,), bool)
        return np.asarray(active, bool)

    def _rand_bits(self, S: int, active: np.ndarray) -> Optional[np.ndarray]:
        """Per-stream rand bits; an inactive stream's rng does not move."""
        if not self._needs_rand:
            return None
        return np.concatenate([
            (self.rngs[i].rand(S) > 0.5).astype(np.int32) if active[i]
            else np.zeros((S,), np.int32) for i in range(self.n_streams)])

    @torch.no_grad()
    def _advance(self, ta, tc, S: int, active: Optional[np.ndarray] = None,
                 sharded: bool = False, group=None) -> torch.Tensor:
        """One window per stream (device queries (C, S, ...)) -> (C, 30)
        int32 codes on the device; the carried seeds move on, except for
        streams marked inactive, whose lanes still compute and whose seeds
        and rng stay as they were. sharded: phase 1 over this rank's
        J-shard, combined across ``group``."""
        act = self._active(active)
        codes, phases = self._codes_d, self._phases_d
        blocks, step_phases, _ = self.engine.scan(
            self.engine.tables(ta, tc, sharded, group), S, self.n_streams,
            self._rand_bits(S, act), _pool_reset_inputs(S, codes, phases))
        out = blocks.reshape(self.n_streams, S * self.cfg.step_sz)[
            :, :self.cfg.num_frames_code]
        # next window's seeds: the last kept code and the final step's
        # phase tail, what predict() chains from one window to the next
        new_codes = out[:, -1]
        new_phases = step_phases.reshape(self.n_streams, S, 8, 16)[:, -1]
        if not act.all():
            act_d = to_device(act, codes.device)
            new_codes = torch.where(act_d, new_codes, codes)
            new_phases = torch.where(act_d[:, None, None], new_phases, phases)
        self._codes_d, self._phases_d = new_codes, new_phases
        return out.to(torch.int32)

    def reset_stream(self, idx: int, init_code: Optional[int] = None,
                     init_phase: Optional[np.ndarray] = None,
                     rng: Optional[np.random.RandomState] = None) -> None:
        """Re-seed stream idx in place (a client left and a new one joined
        its slot). Draws the oracle's init seeds from `rng` (or the
        stream's own rng) when not given, exactly like construction."""
        if rng is not None:
            self.rngs[idx] = rng
        codes0, phases0 = _pool_seeds(
            self.engine, 1, None if init_code is None else [init_code],
            None if init_phase is None else [init_phase], [self.rngs[idx]])
        codes, phases = self._codes_d.clone(), self._phases_d.clone()
        codes[idx] = int(codes0[0])
        phases[idx] = to_device(phases0[0], phases.device)
        self._codes_d, self._phases_d = codes, phases

    def state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(seed codes (C,), seed phases (C, 8, 16)) on the device."""
        return self._codes_d, self._phases_d


class StreamingSession(_Streams):
    """Live matching of staged features: one 4 s window per call, the seed
    code and phase kept on the device between calls.

    The sequential structure of the search (seed code/phase chaining
    across windows, GestureKNN.py:789-802) permits window-at-a-time
    execution: each push uploads only that window's staged features and
    leaves the new seeds on the device. Window w's codes equal whole-clip
    CodeKNNEngine.predict over the same windows (tests)."""

    def __init__(self, engine: CodeKNNEngine,
                 init_code: Optional[int] = None,
                 init_phase: Optional[np.ndarray] = None,
                 rng: Optional[np.random.RandomState] = None):
        super().__init__(engine, 1,
                         None if init_code is None else [init_code],
                         None if init_phase is None else [init_phase],
                         [rng or np.random.RandomState(engine.cfg.seed)])

    @property
    def rng(self) -> np.random.RandomState:
        return self.rngs[0]

    def push_window_device(self, test_audio_w: Optional[np.ndarray],
                           test_context_w: Optional[np.ndarray] = None
                           ) -> torch.Tensor:
        """push_window without the download: (30,) int32 codes on the
        device. Nothing in it waits for the card."""
        cfg = self.cfg
        ta, tc = self.engine.stage_queries(
            test_audio_w[None] if cfg.use_aud else None,
            test_context_w[None] if cfg.use_txt else None)
        S = (ta if ta is not None else tc).shape[1]
        return self._advance(ta, tc, S)[0]

    def push_window(self, test_audio_w: Optional[np.ndarray],
                    test_context_w: Optional[np.ndarray] = None
                    ) -> np.ndarray:
        """One staged window in -> (30,) int32 codes out.

        test_audio_w: (S, ...) one window of stage_test_audio output;
        test_context_w: (S, 384) one window of stage_test_context output.
        The codes are the only download; the seeds stay on the device."""
        return self.push_window_device(test_audio_w,
                                       test_context_w).cpu().numpy()

    def state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(seed_code, seed_phase (8, 16)) on the device."""
        return self._codes_d[0], self._phases_d[0]


class StreamingPool(_Streams):
    """C concurrent live streams of staged features, one tick per window.

    A Python loop over StreamingSession objects pays one scan per stream
    per window. The pool carries every stream's seeds on the device and
    advances all of them one window per tick() through the lane-batched
    fusion scan: each lane's step-0 reset is fed from the carried state,
    so stream i's codes equal those of an independent StreamingSession
    with the same init seeds and rng (tests)."""

    def __init__(self, engine: CodeKNNEngine, n_streams: int,
                 init_codes: Optional[np.ndarray] = None,
                 init_phases: Optional[np.ndarray] = None,
                 rngs: Optional[list] = None):
        super().__init__(engine, n_streams, init_codes, init_phases, rngs)

    def tick_device(self, test_audio: Optional[np.ndarray],
                    test_context: Optional[np.ndarray] = None,
                    active: Optional[np.ndarray] = None,
                    *, sharded: bool = False, group=None) -> torch.Tensor:
        """tick without the download: (C, 30) int32 codes on the device.
        Nothing in it waits for the card (sharded: but the combine)."""
        cfg = self.cfg
        ta, tc = self.engine.stage_queries(
            test_audio if cfg.use_aud else None,
            test_context if cfg.use_txt else None)
        S = (ta if ta is not None else tc).shape[1]
        return self._advance(ta, tc, S, active, sharded, group)

    def tick(self, test_audio: Optional[np.ndarray],
             test_context: Optional[np.ndarray] = None,
             active: Optional[np.ndarray] = None) -> np.ndarray:
        """One staged window per stream in -> (C, 30) int32 codes out.

        test_audio: (C, S, ...) stage_test_audio output, one window per
        stream; test_context: (C, S, 384). active: optional (C,) bool;
        streams marked False keep their seeds (and their rng position),
        and their row of the returned codes is meaningless; pass any
        window (zeros) in their slots."""
        return self.tick_device(test_audio, test_context,
                                active).cpu().numpy()

    def tick_sharded(self, group, test_audio: Optional[np.ndarray],
                     test_context: Optional[np.ndarray] = None,
                     active: Optional[np.ndarray] = None) -> np.ndarray:
        """tick() with database-sharded candidate scoring over the process
        group ``group`` and the per-stream fusion replicated on every rank.
        Bit-identical to tick() with the same inputs; the carried seeds are
        the ones tick() carries, so the two can interleave."""
        return self.tick_device(test_audio, test_context, active,
                                sharded=True, group=group).cpu().numpy()


class StreamingRawWavSession(_Streams):
    """Live matching of raw audio: one raw 4 s wav window per call, codes
    out, the seeds on the device.

    StreamingSession takes host-staged features; this session runs the
    server's encoder (WavLM / vq-wav2vec) and the device staging on each
    pushed window, so a microphone loop ships only the raw int16 window
    (~125 KB at 16 kHz). Window w's codes equal RawWavServer.serve over
    the same windows with the same init seeds (tests). The JAX package's
    ``fused`` argument chose between XLA compiles of one program or two;
    eager PyTorch compiles nothing, so there is no such choice here."""

    def __init__(self, server: RawWavServer,
                 init_code: Optional[int] = None,
                 init_phase: Optional[np.ndarray] = None,
                 rng: Optional[np.random.RandomState] = None):
        self.server = server
        super().__init__(server.engine, 1,
                         None if init_code is None else [init_code],
                         None if init_phase is None else [init_phase],
                         [rng or np.random.RandomState(
                             server.engine.cfg.seed)])
        self.n_steps = server.n_steps

    @property
    def rng(self) -> np.random.RandomState:
        return self.rngs[0]

    def push_wav_device(self, wav_w: np.ndarray,
                        context_w: Optional[np.ndarray] = None
                        ) -> torch.Tensor:
        """push_wav without the download: (30,) int32 codes on the
        device."""
        ctx = context_w[None] if self.cfg.use_txt else None
        ta, tc = self.server.stage(self.server.encode(wav_w[None]), ctx)
        return self._advance(ta, tc, self.n_steps)[0]

    def push_wav(self, wav_w: np.ndarray,
                 context_w: Optional[np.ndarray] = None) -> np.ndarray:
        """One raw wav window (n_samples,) int16/float (+ (30, 384)
        context when the config uses text) -> (30,) int32 codes."""
        return self.push_wav_device(wav_w, context_w).cpu().numpy()

    def state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(seed_code, seed_phase (8, 16)) on the device."""
        return self._codes_d[0], self._phases_d[0]


class StreamingRawWavPool(_Streams):
    """C concurrent live raw-audio streams: wav (C, n_samples) in, codes
    (C, 30) out per tick. The C windows go through the encoder as one batch
    (a solo session runs it at batch 1), then the device staging and the
    lane-batched fusion run as in StreamingPool. Stream i equals a solo
    StreamingRawWavSession with the same seeds and rng. No ``fused``
    argument, for the reason StreamingRawWavSession gives."""

    def __init__(self, server: RawWavServer, n_streams: int,
                 init_codes: Optional[np.ndarray] = None,
                 init_phases: Optional[np.ndarray] = None,
                 rngs: Optional[list] = None):
        self.server = server
        super().__init__(server.engine, n_streams, init_codes, init_phases,
                         rngs)
        self.n_steps = server.n_steps

    def tick_device(self, wav: np.ndarray,
                    context: Optional[np.ndarray] = None,
                    active: Optional[np.ndarray] = None) -> torch.Tensor:
        """tick without the download: (C, 30) int32 codes on the device."""
        ctx = context if self.cfg.use_txt else None
        ta, tc = self.server.stage(self.server.encode(wav), ctx)
        return self._advance(ta, tc, self.n_steps, active)

    def tick(self, wav: np.ndarray, context: Optional[np.ndarray] = None,
             active: Optional[np.ndarray] = None) -> np.ndarray:
        """One raw wav window per stream: wav (C, n_samples) int16/float
        (+ (C, 30, 384) context when the config uses text) -> (C, 30)
        codes. active: optional (C,) bool, as in StreamingPool.tick."""
        with span("tick"):
            _root_counts(self.n_streams, 1)
            codes = self.tick_device(wav, context, active)
            with span("fetch"):
                return codes.cpu().numpy()
