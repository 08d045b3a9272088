"""End-to-end demo on synthetic data (no BEAT download needed).

Walks the product path with small models on the card:
  raw BVH + wav -> rotations / MFCC / prosody (host) -> PAE phases ->
  windows + context -> VQ-VAE codes + signatures -> vq-wav2vec codes ->
  CodeKNN matching (K1) -> decode -> BVH out.

    python -m qpgesture_tpu_torch.examples.demo_synthetic --out DIR
        [--device cuda|cpu]

The weights are the port's own seeded initialisations (no checkpoint
ships); with real BEAT artifacts the same calls run at full size (the
README's CLI equivalents).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core.config import MATCH_PRESETS, MatchConfig, PAEConfig, VQVAEConfig
from ..core.schemas import CodebookSignature
from ..match.database import (stage_database, stage_test_audio,
                              stage_test_context)
from ..match.engine import CodeKNNEngine
from ..models.pae import PAE, PhaseExtractor
from ..models.vq_wav2vec import VQWav2Vec, VQWav2VecConfig
from ..models.vqvae import VQVAE, codebook_signature
from ..motion.bvh import parse_bvh
from ..motion.pipeline import MotionPipeline
from ..pipelines.database_builder import (encode_windows, extract_wavvq,
                                          hashed_embed_fn, process_recording,
                                          window_recordings,
                                          window_test_audio)
from ..render.decode import render_result
from ..train.train_vqvae import seeded_init
from .fixtures import make_beat_like_bvh

JOINTS_DIM = 135
SR, FPS = 16000, 60
NAMES = ("demo_0_1_8", "demo_0_9_16")


def make_recordings(rng, seconds: float = 14.0):
    """(pipeline, recordings): two synthetic 14 s recordings (BEAT-like BVH
    at 120 fps, a 170 Hz tone with noise, a word every 0.6 s) through the
    host stage, the motion pipeline fitted on the first."""
    pipeline = None
    recordings = []
    for name in NAMES:
        bvh = parse_bvh(make_beat_like_bvh(rng, int(seconds * 120)))
        if pipeline is None:
            pipeline = MotionPipeline(fps=FPS).fit(bvh)
        n = int(seconds * SR)
        wav = (0.3 * np.sin(2 * np.pi * 170 * np.arange(n) / SR)
               + 0.02 * rng.randn(n)).astype(np.float32)
        words = [(t, t + 0.25, f"word{int(t*2)}")
                 for t in np.arange(0.3, seconds - 1.0, 0.6)]
        recordings.append(process_recording(name, bvh, wav, pipeline, words))
    return pipeline, recordings


def main(out_dir: str, device="cuda", log=print) -> dict:
    """Returns {"bvh", "npy", "codes", "n_windows"}."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(0)

    log("== step 1-2: recordings -> rotations/MFCC/prosody/windows")
    pipeline, recordings = make_recordings(rng)
    mean = np.zeros(JOINTS_DIM)
    std = np.ones(JOINTS_DIM)

    log("== PAE phases")
    pae = seeded_init(lambda: PAE(PAEConfig(frames=16, joints=15,
                                            channels_per_joint=9),
                                  device="cpu"), 0)
    extractor = PhaseExtractor(pae, device=device)
    for rec in recordings:
        rec.phase = extractor.pose_to_phase(rec.rotation, mean, std)

    log("== windows + context")
    bundle = window_recordings(recordings, 240, embed_fn=hashed_embed_fn())
    log(f"   {bundle.body.shape[0]} windows of {bundle.body.shape[1]}f")

    log("== step 3: VQ-VAE codes + signatures")
    vq = seeded_init(lambda: VQVAE(VQVAEConfig(
        width=32, depth=1, emb_width=32, l_bins=64, input_dim=JOINTS_DIM,
        sample_length=30), device="cpu"), 1).to(device)
    vq.init_codebook_from_batch(
        torch.as_tensor(bundle.body[:2], device=vq.device),
        np.random.RandomState(2))
    codes = encode_windows(vq, bundle.body, mean, std)
    code_arr, poses_arr, sig = codebook_signature(vq, mean, std)
    signature = CodebookSignature(code=code_arr, poses=poses_arr,
                                  signature=sig)

    log("== step 4: vq-wav2vec codes")
    w2v = seeded_init(lambda: VQWav2Vec(VQWav2VecConfig(), device="cpu"),
                      3).to(device)
    wavvq = extract_wavvq(w2v, bundle.wav)

    log("== test clip -> match -> decode")
    test_wav = (0.3 * np.sin(2 * np.pi * 200 * np.arange(int(9 * SR)) / SR)
                ).astype(np.float32)
    windows = window_test_audio(test_wav)
    test_wavvq = extract_wavvq(w2v, windows)
    test_ctx = rng.randn(windows.shape[0], 30, 384).astype(np.float32)

    cfg = MatchConfig(**{**MATCH_PRESETS["wavvq"].__dict__,
                         "codebook_size": 64})
    db = stage_database(cfg, bundle, codes, signature, wavvq=wavvq)
    engine = CodeKNNEngine(cfg, db, device=device)
    result = engine.predict(stage_test_audio(cfg, db, wavvq=test_wavvq),
                            stage_test_context(db, test_ctx))
    log(f"   selected codes: {result.codes.shape}")

    bvh_path, npy_path = render_result(result.codes, vq, pipeline, out_dir,
                                       "demo", data_mean=mean, data_std=std)
    log(f"== wrote {bvh_path}\n== wrote {npy_path}")
    return {"bvh": bvh_path, "npy": npy_path, "codes": result.codes,
            "n_windows": windows.shape[0]}


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="qpg_demo")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    main(args.out, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
