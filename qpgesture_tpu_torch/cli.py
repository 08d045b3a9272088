"""Command-line interface of the port.

Subcommands mirror the reference package's entry points:
  match       GestureKNN.sh / GestureKNN.py main_codebook  -> result.npz
  decode      VisualizeCodebook.py --stage inference       -> BVH (+ npy)
  generate    wav -> encoder -> match -> decode            -> BVH (+ npy)

All take the reference package's flags plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch paths).
"""
from __future__ import annotations

import argparse

import numpy as np

PRESET_CHOICES = ["shipped", "shipped_fast", "wavvq", "wavvq_aud_only",
                  "mfcc", "no_phase", "no_text", "no_audio"]


def _load_match_db(args):
    """Load the bundle/codes/signature(/wavlm/wavvq) files and stage the
    database. Returns (cfg, db)."""
    from .core.config import MATCH_PRESETS, MatchConfig
    from .core.schemas import (CodebookSignature, DatabaseBundle, load_codes,
                               load_wavlm, load_wavvq)
    from .match.database import stage_database

    preset = MATCH_PRESETS[args.preset]
    bundle = DatabaseBundle.load(args.train_database)
    codes = load_codes(args.train_codebook)
    signature = CodebookSignature.load(args.codebook_signature)
    cfg = MatchConfig(**{**preset.__dict__,
                         "desired_k": args.desired_k,
                         "feat_dtype": args.feat_dtype or preset.feat_dtype,
                         "codebook_size": signature.signature.shape[0]})
    wavlm = load_wavlm(args.train_wavlm) if args.train_wavlm else None
    wavvq = load_wavvq(args.train_wavvq) if args.train_wavvq else None
    db = stage_database(cfg, bundle, codes, signature, wavlm=wavlm,
                        wavvq=wavvq)
    return cfg, db


def cmd_match(args):
    from .core.schemas import DatabaseBundle, load_wavlm, load_wavvq, \
        save_result
    from .match.database import stage_test_audio, stage_test_context
    from .match.engine import CodeKNNEngine

    if args.ties == "reference":
        raise NotImplementedError("--ties reference is not ported yet")
    if args.sharded == "always":
        raise NotImplementedError("--sharded always is not ported yet")
    cfg, db = _load_match_db(args)

    test_bundle = DatabaseBundle.load(args.test_data) if args.test_data \
        else None
    test_wavlm = load_wavlm(args.test_wavlm) if args.test_wavlm else None
    test_wavvq = load_wavvq(args.test_wavvq) if args.test_wavvq else None
    test_audio = stage_test_audio(cfg, db, test_bundle=test_bundle,
                                  wavlm=test_wavlm, wavvq=test_wavvq) \
        if cfg.use_aud else None
    test_context = None
    if cfg.use_txt:
        if test_bundle is None or test_bundle.context is None:
            raise SystemExit(
                f"preset {args.preset!r} uses text guidance (use_txt=True) "
                "and needs --test-data pointing at a bundle with a "
                "'context' array; pass one or pick a preset without text "
                "(e.g. no_text, mfcc, wavvq_aud_only)")
        test_context = stage_test_context(db, test_bundle.context)
    if args.max_frames:
        if test_audio is not None:
            test_audio = test_audio[:args.max_frames]
        if test_context is not None:
            test_context = test_context[:args.max_frames]

    # one device: 'auto' sharding never spills
    engine = CodeKNNEngine(cfg, db, device=args.device)
    result = engine.predict(test_audio, test_context)
    save_result(args.out, result.codes)
    print(f"wrote {args.out}: knn_pred {result.codes.shape}")


def cmd_decode(args):
    from .core.config import VQVAEConfig, load_config
    from .core.schemas import load_result
    from .models.convert import load_vqvae_checkpoint
    from .motion.pipeline import MotionPipeline
    from .render.decode import render_result

    if not args.checkpoint.endswith((".bin", ".pt")):
        raise NotImplementedError(
            "only reference torch checkpoints (.bin/.pt) are ported yet; "
            f"got {args.checkpoint}")
    conf = load_config(args.config) if args.config else None
    cfg = conf.vqvae if conf else VQVAEConfig()
    model = load_vqvae_checkpoint(args.checkpoint, cfg, device=args.device)
    with open(args.pipeline) as f:
        pipeline = MotionPipeline.from_json(f.read())
    codes = load_result(args.result)
    mean = std = None
    if conf is not None:
        mean = np.asarray(conf.data_mean) if conf.data_mean else None
        std = np.asarray(conf.data_std) if conf.data_std else None
    bvh_path, npy_path = render_result(
        codes, model, pipeline, args.out, args.prefix,
        data_mean=mean, data_std=std, smoothing=args.smooth)
    print(f"wrote {bvh_path}" + (f" and {npy_path}" if npy_path else ""))


def cmd_generate(args):
    """Wav in, BVH out: the product path in one command (the reference's
    demo wrapper, Speech2GestureMatching/inference.py:19-82, plus decode).
    Window the audio, encode it (vq-wav2vec for wavvq, WavLM for shipped),
    stage the queries, match against the staged database, decode with the
    VQ-VAE, write BVH."""
    from .core.config import MATCH_PRESETS, MatchConfig, VQVAEConfig, \
        load_config
    from .core.schemas import (CodebookSignature, DatabaseBundle, load_codes,
                               load_wavlm, load_wavvq)
    from .match.database import (stage_database, stage_test_audio,
                                 stage_test_context)
    from .match.engine import CodeKNNEngine
    from .models.convert import load_vqvae_checkpoint
    from .motion.pipeline import MotionPipeline
    from .pipelines.database_builder import (extract_wavlm, extract_wavvq,
                                             hashed_embed_fn,
                                             window_test_audio)
    from .render.decode import render_result

    if args.model == "end2end":
        raise NotImplementedError("generate --model end2end is not ported "
                                  "yet")
    if args.resync:
        raise NotImplementedError("generate --resync is not ported yet")
    if args.video:
        raise NotImplementedError("generate --video is not ported yet")
    for req in ("train_database", "train_codebook", "codebook_signature"):
        if not getattr(args, req):
            raise SystemExit(f"--model matching needs "
                             f"--{req.replace('_', '-')}")
    preset = MATCH_PRESETS[args.preset]
    ckpt_arg = "wavvq_checkpoint" if preset.audio_mode == "wavvq_feat" \
        else "wavlm_checkpoint"
    if not getattr(args, ckpt_arg):
        raise SystemExit(f"--preset {args.preset} needs "
                         f"--{ckpt_arg.replace('_', '-')}")
    if not args.vqvae_checkpoint.endswith((".bin", ".pt")):
        raise NotImplementedError(
            "only reference torch checkpoints (.bin/.pt) are ported yet; "
            f"got {args.vqvae_checkpoint}")

    if args.wav.endswith(".npz"):
        wav = np.load(args.wav)["wav"].astype(np.float32).reshape(-1)
    else:
        from .pipelines.audio_prep import load_wav_16k
        wav = load_wav_16k(args.wav)
    windows = window_test_audio(wav)
    print(f"{windows.shape[0]} windows of 4 s")

    bundle = DatabaseBundle.load(args.train_database)
    signature = CodebookSignature.load(args.codebook_signature)
    cfg = MatchConfig(**{**preset.__dict__,
                         "codebook_size": signature.signature.shape[0]})
    db = stage_database(
        cfg, bundle, load_codes(args.train_codebook), signature,
        wavlm=load_wavlm(args.train_wavlm) if args.train_wavlm else None,
        wavvq=load_wavvq(args.train_wavvq) if args.train_wavvq else None)

    if cfg.audio_mode == "wavvq_feat":
        from .models.vq_wav2vec import load_vq_wav2vec_checkpoint
        encoder = load_vq_wav2vec_checkpoint(args.wavvq_checkpoint,
                                             device=args.device)
        test_audio = stage_test_audio(
            cfg, db, wavvq=extract_wavvq(encoder, windows))
    else:
        from .models.wavlm import load_wavlm_checkpoint
        encoder = load_wavlm_checkpoint(args.wavlm_checkpoint,
                                        device=args.device)
        test_audio = stage_test_audio(
            cfg, db, wavlm=extract_wavlm(encoder, windows))
    test_context = None
    if cfg.use_txt:
        # without transcripts the context is the empty-text embedding,
        # replicated per window
        ctx = np.tile(hashed_embed_fn()([""] * 30)[None],
                      (windows.shape[0], 1, 1)).astype(np.float32)
        test_context = stage_test_context(db, ctx)

    engine = CodeKNNEngine(cfg, db, device=args.device)
    codes = engine.predict(test_audio, test_context).codes
    print(f"matched codes {codes.shape}")

    conf = load_config(args.config) if args.config else None
    model = load_vqvae_checkpoint(args.vqvae_checkpoint,
                                  conf.vqvae if conf else VQVAEConfig(),
                                  device=args.device)
    with open(args.pipeline) as f:
        pipeline = MotionPipeline.from_json(f.read())
    mean = np.asarray(conf.data_mean) if conf and conf.data_mean else None
    std = np.asarray(conf.data_std) if conf and conf.data_std else None
    bvh_path, _ = render_result(codes, model, pipeline, args.out,
                                args.prefix, data_mean=mean, data_std=std,
                                smoothing=args.smooth)
    print(f"wrote {bvh_path}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="qpgesture_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("match", help="CodeKNN motion matching")
    m.add_argument("--train-database", required=True)
    m.add_argument("--train-codebook", required=True)
    m.add_argument("--codebook-signature", required=True)
    m.add_argument("--train-wavlm")
    m.add_argument("--train-wavvq")
    m.add_argument("--test-data")
    m.add_argument("--test-wavlm")
    m.add_argument("--test-wavvq")
    m.add_argument("--out", default="./result.npz")
    m.add_argument("--preset", default="shipped", choices=PRESET_CHOICES)
    m.add_argument("--desired-k", type=int, default=0)
    m.add_argument("--feat-dtype", default=None,
                   choices=["float32", "bfloat16", "float16"],
                   help="audio feature-DB residency dtype (only float32 is "
                        "ported yet)")
    m.add_argument("--max-frames", type=int, default=0)
    m.add_argument("--ties", default="stable",
                   choices=["stable", "reference"],
                   help="tie policy: 'stable' (deterministic, all-device); "
                        "'reference' is not ported yet")
    m.add_argument("--sharded", default="auto",
                   choices=["auto", "never", "always"],
                   help="database sharding: one device only ('always' is "
                        "not ported yet)")
    m.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU)")
    m.set_defaults(fn=cmd_match)

    d = sub.add_parser("decode", help="decode result.npz to BVH")
    d.add_argument("--result", required=True)
    d.add_argument("--checkpoint", required=True)
    d.add_argument("--pipeline", required=True,
                   help="MotionPipeline JSON snapshot")
    d.add_argument("--config")
    d.add_argument("--out", default="./output")
    d.add_argument("--prefix", default="generated")
    d.add_argument("--smooth", action="store_true")
    d.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU)")
    d.set_defaults(fn=cmd_decode)

    g = sub.add_parser("generate", help="wav -> gestures (match + decode)")
    g.add_argument("--wav", required=True)
    g.add_argument("--model", choices=("matching", "end2end"),
                   default="matching",
                   help="'matching' = KNN against the database (default); "
                        "'end2end' is not ported yet")
    g.add_argument("--train-database")
    g.add_argument("--train-codebook")
    g.add_argument("--codebook-signature")
    g.add_argument("--train-wavlm")
    g.add_argument("--train-wavvq")
    g.add_argument("--wavvq-checkpoint",
                   help="fairseq vq-wav2vec .pt (--preset wavvq)")
    g.add_argument("--wavlm-checkpoint",
                   help="Microsoft WavLM .pt (--preset shipped)")
    g.add_argument("--vqvae-checkpoint", required=True)
    g.add_argument("--pipeline", required=True,
                   help="MotionPipeline JSON snapshot")
    g.add_argument("--config")
    g.add_argument("--preset", default="wavvq", choices=["shipped", "wavvq"])
    g.add_argument("--out", default="./output")
    g.add_argument("--prefix", default="generated")
    g.add_argument("--smooth", action="store_true")
    g.add_argument("--video", action="store_true",
                   help="not ported yet")
    g.add_argument("--resync", metavar="CKPT", help="not ported yet")
    g.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU)")
    g.set_defaults(fn=cmd_generate)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
