"""Command-line interface of the port.

Subcommands mirror the reference package's entry points:
  match          GestureKNN.sh / GestureKNN.py main_codebook  -> result.npz
  decode         VisualizeCodebook.py --stage inference       -> BVH (+ npy)
  generate       wav -> encoder -> match -> decode            -> BVH (+ npy)
  warmup         build the kernels, one predict per bucket
  signature      VisualizeCodebook.py --stage train           -> code.npz
  test-audio     make_test_data.py                            -> wavvq_240.npz
  build-db       make_beat_dataset.py steps 2-4               -> bundles, codes
  phase          PAE.py --stage inference                     -> Phase npz
  assemble-beat  make_beat_dataset.py step 1                  -> Audio/ Motion/

They take the reference package's flags; those that run a model also take
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch paths).
"""
from __future__ import annotations

import argparse
import glob
import os

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


def _load_vqvae(path: str, cfg, device):
    from .models.convert import load_vqvae_checkpoint
    if not path.endswith((".bin", ".pt")):
        raise NotImplementedError(
            "only reference torch checkpoints (.bin/.pt) are ported yet; "
            f"got {path}")
    return load_vqvae_checkpoint(path, cfg, device=device)


def cmd_decode(args):
    from .core.config import VQVAEConfig, load_config
    from .core.schemas import load_result
    from .motion.pipeline import MotionPipeline
    from .render.decode import render_result

    conf = load_config(args.config) if args.config else None
    model = _load_vqvae(args.checkpoint,
                        conf.vqvae if conf else VQVAEConfig(), args.device)
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


def cmd_warmup(args):
    """Build the CUDA kernels and run the serving paths once per bucket.

    Without an XLA compile cache there is no program to pre-compile: what
    persists between processes is the nvcc build of the kernels (the
    git-ignored ``_build/`` next to their sources), which later processes
    load instead of compiling. What a process builds for itself (cuDNN and
    cuBLAS plans, the CUDA context, staged databases) does not persist, so
    this warms the build and checks, bucket by bucket, that the database
    serves."""
    import time

    import torch

    from .device import resolve_device
    from .match.engine import CodeKNNEngine

    if args.rawpose_batch:
        raise NotImplementedError("warmup --rawpose-batch is not ported yet")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from .ops import cuda_build, flash_attention_cuda, levenshtein_cuda
        t0 = time.perf_counter()
        cuda_build.build_all([levenshtein_cuda.SOURCE,
                              flash_attention_cuda.SOURCE])
        print(f"kernels built: {time.perf_counter() - t0:7.1f} s")
    cfg, db = _load_match_db(args)
    engine = CodeKNNEngine(cfg, db, device=dev)
    rng = np.random.RandomState(0)
    S = len(db.geom.step_clip_idx)
    buckets = [int(b) for b in args.buckets.split(",")]

    def inputs(C):
        ta = tc = None
        if cfg.use_aud:
            if cfg.audio_mode == "wavvq_feat":
                shape = (C, S) + db.aud_strings.shape[2:]
                ta = rng.randint(0, 320, size=shape).astype(np.int32)
            else:
                ta = rng.randn(C, S, db.aud_feat.shape[-1]).astype(np.float32)
        if cfg.use_txt:
            tc = rng.randn(C, S, db.txt_feat.shape[-1]).astype(np.float32)
        return ta, tc

    model = pipeline = None
    if args.decode:
        from .core.config import VQVAEConfig, load_config
        vq_cfg = load_config(args.config).vqvae if args.config \
            else VQVAEConfig()
        if args.checkpoint:
            model = _load_vqvae(args.checkpoint, vq_cfg, dev)
        else:
            from .models.vqvae import VQVAE
            model = VQVAE(vq_cfg, device=dev)
        if args.serving:
            from .serve import ServingPipeline
            pipeline = ServingPipeline(engine, model)

    for W in buckets:
        ta, tc = inputs(W)
        t0 = time.perf_counter()
        res = engine.predict(ta, tc)
        if model is not None:
            model.decode(torch.as_tensor(res.codes.reshape(1, -1),
                                         device=dev)).cpu()
        if pipeline is not None:
            pipeline.serve(ta, tc)
        print(f"bucket W={W:4d}: first call {time.perf_counter() - t0:7.1f} s")
    if args.streams:
        if not cfg.chain_windows:
            print(f"streams: preset {args.preset} is non-chaining; "
                  f"streaming pool not applicable, skipped")
        else:
            from .serve import StreamingPool, StreamingSession
            pool = StreamingPool(engine, args.streams)
            ta, tc = inputs(args.streams)
            t0 = time.perf_counter()
            pool.tick(ta, tc)
            print(f"streams C={args.streams}: first tick "
                  f"{time.perf_counter() - t0:7.1f} s")
            session = StreamingSession(engine)
            sa, sc = inputs(1)
            t0 = time.perf_counter()
            session.push_window(sa[0] if sa is not None else None,
                                sc[0] if sc is not None else None)
            print(f"solo stream: first push "
                  f"{time.perf_counter() - t0:7.1f} s")
    print(f"warm: {len(buckets)} bucket(s), preset {args.preset}"
          f"{', decode' if model is not None else ''}"
          f"{', serving' if pipeline is not None else ''}"
          + (f", {args.streams}-stream pool + solo session"
             if args.streams and cfg.chain_windows else ""))


def cmd_signature(args):
    from .core.config import VQVAEConfig, load_config
    from .core.schemas import CodebookSignature
    from .device import resolve_device
    from .models.vqvae import codebook_signature

    dev = resolve_device(args.device)
    conf = load_config(args.config) if args.config else None
    model = _load_vqvae(args.checkpoint, conf.vqvae if conf else VQVAEConfig(),
                        dev)
    mean = np.asarray(conf.data_mean) if conf and conf.data_mean else None
    std = np.asarray(conf.data_std) if conf and conf.data_std else None
    code, poses, sig = codebook_signature(model, mean, std)
    CodebookSignature(code=code, poses=poses, signature=sig).save(args.out)
    print(f"wrote {args.out}: signature {sig.shape}")


def cmd_test_audio(args):
    from .core.schemas import save_wavvq
    from .device import resolve_device
    from .pipelines.database_builder import extract_wavvq, window_test_audio

    dev = resolve_device(args.device)
    if args.wav.endswith(".npz"):
        wav = np.load(args.wav)["wav"].astype(np.float32)
    else:
        from .pipelines.audio_prep import load_wav_16k
        wav = load_wav_16k(args.wav)
    windows = window_test_audio(wav)
    if "wavvq" in args.out:
        wav_out = args.out.replace("wavvq", "wav")
    else:  # never reuse args.out for both arrays
        root, ext = os.path.splitext(args.out)
        wav_out = f"{root}_wav{ext or '.npz'}"
    np.savez_compressed(wav_out, wav=windows)
    if args.wavvq_checkpoint:
        from .models.vq_wav2vec import load_vq_wav2vec_checkpoint
        model = load_vq_wav2vec_checkpoint(args.wavvq_checkpoint, device=dev)
        codes = extract_wavvq(model, windows)
        save_wavvq(args.out, codes)
        print(f"wrote {args.out}: wavvq {codes.shape}")
    else:
        print(f"wrote wav windows {windows.shape}; pass --wavvq-checkpoint "
              "to extract codes")


def _sentence_embed_fn(path: str, device):
    """--sentence-model: the port's MiniLM on `device` for a checkpoint
    directory holding vocab.txt, else host sentence-transformers."""
    from .pipelines import database_builder as builder
    if os.path.isdir(path) and os.path.exists(
            os.path.join(path, "vocab.txt")):
        return builder.minilm_embed_fn(path, device=device)
    return builder.sentence_transformer_embed_fn(path)


def cmd_build_db(args):
    """Database construction for a new speaker (make_beat_dataset steps 2-4):
    (BVH, wav[, transcript]) recordings -> per-split window bundles + stats
    + pipeline snapshot (+ codes / wavvq / WavLM features / phases when the
    corresponding checkpoints are given). Each checkpoint is loaded once."""
    from .core.config import PAEConfig, VQVAEConfig, load_config
    from .device import resolve_device
    from .motion.bvh import parse_bvh
    from .motion.pipeline import MotionPipeline
    from .pipelines import database_builder as builder
    from .pipelines.audio_prep import ensure_16k_wav, read_wav
    from .pipelines.transcripts import read_tab_transcript
    from .train.data import dataset_stats

    if args.dataset == "trinity":
        raise NotImplementedError("build-db --dataset trinity is not ported "
                                  "yet")
    dev = resolve_device(args.device)
    if not (args.bvh_dir and args.wav_dir):
        raise SystemExit("--bvh-dir and --wav-dir are required for the "
                         "BEAT builder (--dataset beat)")
    os.makedirs(args.out, exist_ok=True)
    bvh_files = sorted(glob.glob(os.path.join(args.bvh_dir, "*.bvh")))
    if not bvh_files:
        raise SystemExit(f"no .bvh files in {args.bvh_dir}")
    conf = load_config(args.config) if args.config else None

    pipeline = None
    recordings = []
    for bvh_path in bvh_files:
        name = os.path.splitext(os.path.basename(bvh_path))[0]
        split = builder.split_of(name)
        if split is None:
            print(f"skip {name}")
            continue
        # raw 44.1 kHz (or stereo/24-bit) input converts automatically
        wav_path = ensure_16k_wav(os.path.join(args.wav_dir, name + ".wav"),
                                  os.path.join(args.out, "_audio16k"))
        wav, wav_sr = read_wav(wav_path)
        if wav_sr != 16000:
            raise SystemExit(f"{wav_path}: expected 16 kHz, got {wav_sr}")
        wav = wav.astype(np.float32)
        words = []
        tpath = os.path.join(args.transcript_dir or "", name + ".txt")
        if args.transcript_dir and os.path.exists(tpath):
            words = read_tab_transcript(tpath)
            if not words and args.gentle:
                # raw (unaligned) text: drive a gentle run
                # (align_words, process_beat_txt.py:49-81)
                from .pipelines.transcripts import (GentleUnavailable,
                                                    run_gentle)
                try:
                    with open(tpath, encoding="utf-8") as f:
                        words = run_gentle(wav_path, f.read())
                except GentleUnavailable as e:
                    print(f"{name}: gentle alignment skipped ({e})")
        bvh = parse_bvh(bvh_path)
        if pipeline is None:
            pipeline = MotionPipeline(fps=args.fps).fit(bvh)
            with open(os.path.join(args.out, "pipeline.json"), "w") as f:
                f.write(pipeline.to_json())
        rec = builder.process_recording(name, bvh, wav, pipeline, words,
                                        fps=args.fps)
        recordings.append(rec)
        print(f"{name}: {rec.rotation.shape[0]} frames ({split})")

    mean, std = dataset_stats([{"poses": r.rotation} for r in recordings])
    np.savez(os.path.join(args.out, "stats.npz"), mean=mean, std=std)

    if args.pae_checkpoint:
        from .models.convert import load_pae_checkpoint
        from .models.pae import PhaseExtractor
        extractor = PhaseExtractor(load_pae_checkpoint(
            args.pae_checkpoint, conf.pae if conf else PAEConfig(),
            device=dev), device=dev)
        for rec in recordings:
            rec.phase = extractor.pose_to_phase(rec.rotation, mean, std)

    embed = builder.hashed_embed_fn() if args.hashed_context else None
    if args.sentence_model:
        embed = _sentence_embed_fn(args.sentence_model, dev)

    splits = {"train": [], "validation": [], "test": []}
    for rec in recordings:
        splits[builder.split_of(rec.name)].append(rec)

    vq_model = wavvq_model = wavlm_model = None
    if args.vqvae_checkpoint:
        vq_model = _load_vqvae(args.vqvae_checkpoint,
                               conf.vqvae if conf else VQVAEConfig(), dev)
    if args.wavvq_checkpoint:
        from .models.vq_wav2vec import load_vq_wav2vec_checkpoint
        wavvq_model = load_vq_wav2vec_checkpoint(args.wavvq_checkpoint,
                                                 device=dev)
    if args.wavlm_checkpoint:
        from .models.wavlm import load_wavlm_checkpoint
        wavlm_model = load_wavlm_checkpoint(args.wavlm_checkpoint, device=dev)

    for split, recs in splits.items():
        if not recs:
            continue
        stem = os.path.join(args.out, f"{args.prefix}_{split}_{args.n_frames}")
        bundle = builder.window_recordings(recs, n_frames=args.n_frames,
                                           embed_fn=embed)
        bundle.save(f"{stem}_txt_2.npz")
        print(f"wrote {stem}_txt_2.npz: {bundle.body.shape[0]} windows")
        if vq_model is not None:
            codes = builder.encode_windows(vq_model, bundle.body, mean, std)
            np.savez_compressed(f"{stem}_code.npz", code=codes)
            print(f"wrote {stem}_code.npz: {codes.shape}")
        if wavvq_model is not None:
            wavvq = builder.extract_wavvq(wavvq_model, bundle.wav)
            np.savez_compressed(f"{stem}_WavVQ.npz", wavvq=wavvq)
            print(f"wrote {stem}_WavVQ.npz: {wavvq.shape}")
        if wavlm_model is not None:
            feats = builder.extract_wavlm(wavlm_model, bundle.wav)
            np.savez_compressed(f"{stem}_WavLM.npz", wavlm=feats)
            print(f"wrote {stem}_WavLM.npz: {feats.shape}")


def cmd_phase(args):
    """PAE.py --stage inference: Rotation/*.npz -> Phase/*.npz with dense
    (T, 4, 8) phases; files already in --out are kept."""
    from .core.config import load_config
    from .device import resolve_device
    from .models.convert import load_pae_checkpoint
    from .models.pae import PhaseExtractor

    dev = resolve_device(args.device)
    conf = load_config(args.config)
    extractor = PhaseExtractor(
        load_pae_checkpoint(args.checkpoint, conf.pae, device=dev), device=dev)
    mean = np.asarray(conf.data_mean).squeeze()
    std = np.asarray(conf.data_std).squeeze()
    os.makedirs(args.out, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(args.rotation_dir, "*.npz"))):
        name = os.path.basename(path)
        dst = os.path.join(args.out, name)
        if os.path.exists(dst):
            continue
        phase = extractor.pose_to_phase(np.load(path)["upper"], mean, std)
        np.savez_compressed(dst, phase=phase)
        print(f"{name}: phase {phase.shape}")


def cmd_assemble_beat(args):
    """BEAT step-1 assembly (make_beat_dataset.py:17-96): orig-BEAT tree ->
    <out>/{Audio,Motion} with paired recordings only and repaired BVH
    Frames headers; optional resample/normalize of the copied audio."""
    from .pipelines.audio_prep import normalize_wav, resample_wav
    from .pipelines.beat_assembly import assemble_beat_dataset

    summary = assemble_beat_dataset(args.orig_root, args.out,
                                    speakers=args.speakers)
    print(f"copied {summary['n_pairs']} paired recordings; repaired "
          f"{len(summary['repaired'])} BVH headers")
    if args.normalize or args.resample:
        out_dir = os.path.join(args.out, "Audio_normalized"
                               if args.normalize else "Audio_16k")
        backend = None
        for wav in sorted(glob.glob(
                os.path.join(summary["audio_dir"], "*.wav"))):
            dst = os.path.join(out_dir, os.path.basename(wav))
            backend = (normalize_wav(wav, dst) if args.normalize
                       else resample_wav(wav, dst))
        print(f"audio prepared into {out_dir} (backend: {backend})")


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

    wu = sub.add_parser(
        "warmup", help="build the CUDA kernels and run every serving path "
                       "once per bucket (run once at deploy time)")
    wu.add_argument("--train-database", required=True)
    wu.add_argument("--train-codebook", required=True)
    wu.add_argument("--codebook-signature", required=True)
    wu.add_argument("--train-wavlm")
    wu.add_argument("--train-wavvq")
    wu.add_argument("--preset", default="shipped", choices=PRESET_CHOICES)
    wu.add_argument("--buckets", default="1,2,4,8,16",
                    help="comma-separated window counts to run")
    wu.add_argument("--decode", action="store_true",
                    help="also run the VQ-VAE decode per bucket")
    wu.add_argument("--serving", action="store_true",
                    help="with --decode: also run ServingPipeline.serve per "
                         "bucket")
    wu.add_argument("--checkpoint",
                    help="VQ-VAE checkpoint for --decode (optional: random "
                         "weights of the config exercise the same path)")
    wu.add_argument("--config")
    wu.add_argument("--desired-k", type=int, default=0)
    wu.add_argument("--feat-dtype", default=None,
                    choices=["float32", "bfloat16", "float16"],
                    help="feature-DB residency dtype (only float32 is ported "
                         "yet)")
    wu.add_argument("--streams", type=int, default=0,
                    help="also run one StreamingPool tick for this many "
                         "streams, and one solo StreamingSession push")
    wu.add_argument("--rawpose-batch", type=int, default=0,
                    help="not ported yet")
    wu.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a GPU)")
    wu.set_defaults(fn=cmd_warmup)

    s = sub.add_parser("signature", help="build code.npz signatures")
    s.add_argument("--checkpoint", required=True)
    s.add_argument("--config")
    s.add_argument("--out", default="./code.npz")
    s.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU)")
    s.set_defaults(fn=cmd_signature)

    t = sub.add_parser("test-audio", help="wav -> wavvq_240.npz")
    t.add_argument("--wav", required=True)
    t.add_argument("--out", default="./wavvq_240.npz")
    t.add_argument("--wavvq-checkpoint")
    t.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU)")
    t.set_defaults(fn=cmd_test_audio)

    bd = sub.add_parser("build-db", help="build a speaker database from "
                        "(BVH, wav, transcript) recordings")
    bd.add_argument("--dataset", default="beat", choices=["beat", "trinity"],
                    help="'trinity' is not ported yet")
    bd.add_argument("--bvh-dir")
    bd.add_argument("--wav-dir")
    bd.add_argument("--transcript-dir")
    bd.add_argument("--trn-path", help="trinity: not ported yet")
    bd.add_argument("--val-path", help="trinity: not ported yet")
    bd.add_argument("--mode", default="rotation",
                    choices=["rotation", "position"],
                    help="trinity: not ported yet")
    bd.add_argument("--out", required=True)
    bd.add_argument("--prefix", default="speaker")
    bd.add_argument("--fps", type=int, default=60)
    bd.add_argument("--n-frames", type=int, default=240)
    bd.add_argument("--config")
    bd.add_argument("--vqvae-checkpoint")
    bd.add_argument("--wavvq-checkpoint")
    bd.add_argument("--wavlm-checkpoint")
    bd.add_argument("--pae-checkpoint")
    bd.add_argument("--sentence-model",
                    help="MiniLM checkpoint dir for context embeddings (the "
                         "port's MiniLM on --device when the dir has "
                         "vocab.txt; else host sentence-transformers)")
    bd.add_argument("--hashed-context", action="store_true",
                    help="deterministic hashed embeddings (offline)")
    bd.add_argument("--gentle", action="store_true",
                    help="align raw-text transcripts with gentle "
                         "($GENTLE_URL or $GENTLE_CMD)")
    bd.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a GPU)")
    bd.set_defaults(fn=cmd_build_db)

    ph = sub.add_parser("phase", help="extract PAE phases for Rotation/*.npz")
    ph.add_argument("--checkpoint", required=True)
    ph.add_argument("--config", required=True)
    ph.add_argument("--rotation-dir", required=True)
    ph.add_argument("--out", required=True)
    ph.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a GPU)")
    ph.set_defaults(fn=cmd_phase)

    ab = sub.add_parser("assemble-beat",
                        help="step-1 orig-BEAT assembly: copy paired "
                             "wav/bvh + repair Frames headers (host only)")
    ab.add_argument("--orig-root", required=True)
    ab.add_argument("--out", required=True)
    ab.add_argument("--speakers", nargs="*",
                    help="restrict to these speaker ids")
    ab.add_argument("--resample", action="store_true",
                    help="also produce Audio_16k/")
    ab.add_argument("--normalize", action="store_true",
                    help="also produce Audio_normalized/")
    ab.set_defaults(fn=cmd_assemble_beat)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
