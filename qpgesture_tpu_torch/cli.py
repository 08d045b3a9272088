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
  resync-apply   ResyncGestureKNN.py stage 2                  -> knn_pred npz
  verify-release the acceptance gate on a published artifact tree
  train-vqvae    train.py --config codebook.yml               -> <out>/*.pt
  train-pae      PAE.py --stage train                         -> <out>/*.pt
  train-end2end  end2end.py (the GRU baseline)                -> <out>/*.pt
  train-resync   train_resync_gestureknn.py (WGAN-GP)         -> <out>/latest.pt
  train-fgd      the feature-space FGD extractor              -> checkpoint file
  evaluate       Hellinger + FGD between motion sets          -> one JSON line
  plot           training curves, phase manifold, debug views -> PNG / video
  bench          the headline benchmark on the card (bench.py)  -> JSON lines

They take the reference package's flags; those that run a model also take
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch paths).

``match``, ``train-vqvae``, ``train-pae`` and ``train-end2end`` also run
as one process per rank under ``python -m torch.distributed.run
--nproc-per-node N -m qpgesture_tpu_torch ...``: ``match --sharded``
shards the database over the ranks, the trainers split every batch among
them. Each rank's device is cuda:{LOCAL_RANK} (a bare ``--device cuda``);
``--dist-backend`` picks the backend (nccl on the card, gloo on the CPU,
or for ranks that share one card: ``--device cuda:0 --dist-backend
gloo``). Rank 0 alone writes files and prints results.
"""
from __future__ import annotations

import argparse
import functools
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


def _in_group(cmd):
    """cmd(args, dev) as a subcommand that joins the group that
    torch.distributed.run describes in its environment (a lone process is a
    world of one), runs on this rank's device and leaves the group when
    done."""
    @functools.wraps(cmd)
    def run(args):
        from .parallel.dist import env_group
        with env_group(args.device, args.dist_backend) as dev:
            return cmd(args, dev)
    return run


@_in_group
def cmd_match(args, dev):
    from .core.schemas import DatabaseBundle, load_wavlm, load_wavvq, \
        save_result
    from .match.database import stage_test_audio, stage_test_context
    from .match.engine import CodeKNNEngine, should_shard
    from .parallel.dist import is_main, world_size

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

    engine = CodeKNNEngine(cfg, db, device=dev)
    if args.ties == "reference":
        # phase 1 on the device, the fusion in the reference's arithmetic
        result = engine.predict_reference_ties(test_audio, test_context)
    elif args.sharded == "always" or (args.sharded == "auto"
                                      and should_shard(cfg, db, device=dev)):
        if is_main():
            print(f"sharding the database's J axis over {world_size()} "
                  "rank(s)")
        result = engine.predict_sharded(None, test_audio, test_context)
    else:
        result = engine.predict(test_audio, test_context)
    if is_main():
        save_result(args.out, result.codes)
        print(f"wrote {args.out}: knn_pred {result.codes.shape}")


def _load_vqvae(path: str, cfg, device):
    """A reference torch checkpoint (.bin/.pt), the JAX package's msgpack
    checkpoint (.msgpack, ``save_vqvae_native``), or a train-vqvae output
    directory (its best.pt)."""
    if path.endswith(".msgpack"):
        from .models.vqvae import load_vqvae_native
        return load_vqvae_native(path, cfg, device=device)
    from .models.convert import load_vqvae_checkpoint
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


def _end2end_windows(wav: np.ndarray, max_frames: int = 0) -> np.ndarray:
    """Non-overlapping 4 s subdivision with a zero-padded trailing window,
    the end2end serving split (codebook/inference.py:33-43,67-75; the
    matching path's window_test_audio drops the partial tail instead).
    max_frames clamps like inference.py:40-41 (MAX_FRAMES=3600 -> 15
    windows)."""
    import math

    from .core import constants as C
    unit = int(C.NUM_FRAMES / C.FPS * C.SR)  # 4 s * 16 kHz = 64000
    n_sub = 1 if len(wav) < unit else \
        math.ceil((len(wav) - unit) / unit) + 1
    if max_frames:
        n_sub = min(n_sub, max(1, int(max_frames / C.NUM_FRAMES)))
    wins = np.zeros((n_sub, unit), np.float32)
    for i in range(n_sub):
        chunk = wav[i * unit:(i + 1) * unit]
        wins[i, :len(chunk)] = chunk
    return wins


def _feature_encoder_arg(args, who: str) -> str:
    """The one 50 Hz feature encoder checkpoint flag given: wavlm or
    w2v_bert; exits unless exactly one of the two is."""
    given = [a for a in ("wavlm_checkpoint", "w2v_bert_checkpoint")
             if getattr(args, a, None)]
    if len(given) != 1:
        raise SystemExit(f"{who} needs exactly one of --wavlm-checkpoint "
                         f"and --w2v-bert-checkpoint")
    return given[0]


def _load_feature_encoder(args, device):
    """WavLM or w2v-BERT from the checkpoint flag given: either returns
    the (W, 199, D) features the wavlm modes stage."""
    if _feature_encoder_arg(args, "the wavlm modes") == "wavlm_checkpoint":
        from .models.wavlm import load_wavlm_checkpoint
        return load_wavlm_checkpoint(args.wavlm_checkpoint, device=device)
    from .models.w2v_bert import load_w2v_bert_checkpoint
    return load_w2v_bert_checkpoint(args.w2v_bert_checkpoint, device=device)


def _match_codes(args, wav: np.ndarray):
    """--model matching: window the audio, encode it (vq-wav2vec for the
    wavvq presets, WavLM or w2v-BERT for every other), match against the
    staged database. Returns ((W, 30) codes, the train bundle)."""
    from .core.config import MATCH_PRESETS, MatchConfig
    from .core.schemas import (CodebookSignature, DatabaseBundle, load_codes,
                               load_wavlm, load_wavvq)
    from .match.database import (stage_database, stage_test_audio,
                                 stage_test_context)
    from .match.engine import CodeKNNEngine
    from .pipelines.database_builder import (extract_wavlm, extract_wavvq,
                                             hashed_embed_fn,
                                             window_test_audio)

    for req in ("train_database", "train_codebook", "codebook_signature"):
        if not getattr(args, req):
            raise SystemExit(f"--model matching needs "
                             f"--{req.replace('_', '-')}")
    preset = MATCH_PRESETS[args.preset]
    if preset.audio_mode == "wavvq_feat":
        if not args.wavvq_checkpoint:
            raise SystemExit(f"--preset {args.preset} needs "
                             f"--wavvq-checkpoint")
    else:
        _feature_encoder_arg(args, f"--preset {args.preset}")
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
        encoder = _load_feature_encoder(args, args.device)
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
    return codes, bundle


def _make_resync_transform(ckpt: str, wav: np.ndarray, bundle, device,
                           n_joints: int = 135, n_mfcc: int = 13):
    """The render_result pose_transform that applies a trained ResyncNet to
    decoded KNN motion (`generate --resync`): per 4 s window, (MFCC |
    motion) -> generator -> resynced motion. Stats come from the train
    database bundle, as in ResyncGestureKNN.main:126-137."""
    from .core import constants as C
    from .models.convert import load_resync_checkpoint
    from .models.resync import predict_resynced_gesture, resync_stats
    from .ops.mfcc import MFCCConfig, sphinx_mfcc_np

    if bundle.mfcc is None or bundle.body is None:
        raise SystemExit("--resync needs a train database bundle with "
                         "'mfcc' and 'body' arrays (the stats source)")
    stats = resync_stats(bundle.mfcc[:, :, :n_mfcc], bundle.body)
    mfcc_full = sphinx_mfcc_np(wav, MFCCConfig(frate=C.FPS)).astype(
        np.float32)[:, :n_mfcc]
    gen = load_resync_checkpoint(ckpt, device=device)

    def transform(poses: np.ndarray) -> np.ndarray:
        T = C.NUM_FRAMES
        W = poses.shape[0] // T
        mf = mfcc_full
        if mf.shape[0] < W * T:
            mf = np.pad(mf, ((0, W * T - mf.shape[0]), (0, 0)))
        mf = mf[:W * T].reshape(W, T, n_mfcc)
        motion = poses[:W * T].reshape(W, T, n_joints)
        out = predict_resynced_gesture(gen, mf, motion, *stats)
        resynced = poses.copy()
        resynced[:W * T] = out.reshape(-1, n_joints)
        return resynced

    return transform


def cmd_generate(args):
    """Wav in, BVH out: the product path in one command (the reference's
    demo wrapper, Speech2GestureMatching/inference.py:19-82, plus decode).

    --model matching windows the audio, encodes it, matches it against the
    staged database; --model end2end is the "w/o motion matching"
    ablation's serving path (codebook/inference.py:26-98): the GRU baseline
    predicts the code string from raw audio, with no database. Both decode
    with the VQ-VAE and write BVH; --resync applies a trained ResyncNet to
    the decoded motion first."""
    from .core.config import VQVAEConfig, load_config
    from .core.schemas import DatabaseBundle
    from .device import resolve_device
    from .motion.pipeline import MotionPipeline
    from .render.decode import render_result

    if args.wav.endswith(".npz"):
        wav = np.load(args.wav)["wav"].astype(np.float32).reshape(-1)
    else:
        from .pipelines.audio_prep import load_wav_16k
        wav = load_wav_16k(args.wav)
    conf = load_config(args.config) if args.config else None

    bundle = None
    if args.model == "end2end":
        import torch

        from .models.convert import load_generator_gru_checkpoint
        if not args.end2end_checkpoint:
            raise SystemExit("--model end2end needs --end2end-checkpoint")
        windows = _end2end_windows(wav, max_frames=args.max_frames)
        print(f"{windows.shape[0]} windows of 4 s (end2end)")
        gen = load_generator_gru_checkpoint(args.end2end_checkpoint,
                                            device=args.device)
        # one batch over every window; the reference loops window at a
        # time (inference.py:67-80)
        codes = gen.sample(torch.as_tensor(windows, device=gen.device)
                           ).cpu().numpy().astype(np.int32)
        print(f"sampled codes {codes.shape}")
    else:
        codes, bundle = _match_codes(args, wav)

    model = _load_vqvae(args.vqvae_checkpoint,
                        conf.vqvae if conf else VQVAEConfig(), args.device)
    with open(args.pipeline) as f:
        pipeline = MotionPipeline.from_json(f.read())
    mean = np.asarray(conf.data_mean) if conf and conf.data_mean else None
    std = np.asarray(conf.data_std) if conf and conf.data_std else None

    pose_transform = None
    if args.resync:
        # stage-2 resync (ResyncGestureKNN.py:155-175): the trained UNet
        # re-syncs the decoded KNN motion to the audio's MFCCs before BVH
        if bundle is None:
            if not args.train_database:
                raise SystemExit("--resync needs --train-database (the "
                                 "mfcc/body stats source)")
            bundle = DatabaseBundle.load(args.train_database)
        pose_transform = _make_resync_transform(
            args.resync, wav, bundle, resolve_device(args.device))
        print(f"applying ResyncNet from {args.resync}")
    bvh_path, npy_path = render_result(codes, model, pipeline, args.out,
                                       args.prefix, data_mean=mean,
                                       data_std=std, smoothing=args.smooth,
                                       pose_transform=pose_transform)
    if args.model == "end2end":
        # the reference also keeps the sampled code string
        # (inference.py:96)
        code_path = os.path.join(args.out, f"code_{args.prefix}.npy")
        np.save(code_path, codes)
        print(f"wrote {code_path}")
    print(f"wrote {bvh_path}")
    if args.video and npy_path:
        from .render.visualize import render_positions
        out = render_positions(np.load(npy_path),
                               bvh_path.replace(".bvh", ".mp4"), codes=codes)
        print(f"wrote {out}")


def cmd_resync_apply(args):
    """Stage-2 resync of KNN output (ResyncGestureKNN.py:43-87,155-175):
    load knn_pred, normalize with the train database's stats, run the
    trained generator over every sequence in one batch on the device, and
    save the resynced motion under the same npz schema."""
    from .device import resolve_device
    from .models.convert import load_resync_checkpoint
    from .models.resync import predict_resynced_gesture, resync_stats

    dev = resolve_device(args.device)
    knn = np.load(args.knn)["knn_pred"]
    test = np.load(args.test_data)
    mfcc_test = test["mfcc"][:, :, :args.n_mfcc].astype(np.float32)
    train = np.load(args.train_database)
    stats = resync_stats(train["mfcc"][:, :, :args.n_mfcc], train["body"])

    # knn_pred ships in the reference's (N, J, T) layout
    # (ResyncGestureKNN.py:160); --layout ntj takes (N, T, J)
    knn_motion = knn.transpose(0, 2, 1) if args.layout == "njt" else knn
    n_seq = args.frames or knn_motion.shape[0]
    knn_motion = knn_motion[:n_seq].astype(np.float32)
    mfcc_test = mfcc_test[:n_seq]
    if mfcc_test.shape[1] != knn_motion.shape[1]:
        raise SystemExit(f"test mfcc {mfcc_test.shape} and knn motion "
                         f"{knn_motion.shape} differ in frames")
    gen = load_resync_checkpoint(args.checkpoint, device=dev)
    out = predict_resynced_gesture(gen, mfcc_test, knn_motion, *stats)
    if args.layout == "njt":
        out = out.transpose(0, 2, 1)
    np.savez_compressed(args.out, knn_pred=out)
    print(f"wrote {args.out}: resynced knn_pred {out.shape}")


def cmd_verify_release(args):
    """The real-artifact acceptance gate (pipelines/release.py)."""
    from .pipelines.release import verify_release

    overrides = {
        "train_db": args.train_db, "test_db": args.test_db,
        "train_code": args.train_code, "signature": args.signature,
        "train_wavlm": args.train_wavlm, "test_wavlm": args.test_wavlm,
        "train_wavvq": args.train_wavvq, "test_wavvq": args.test_wavvq,
        "checkpoint": args.checkpoint,
    }
    card = verify_release(args.root, overrides=overrides,
                          expected=args.expected, config=args.config,
                          out=args.out, subsample=args.subsample,
                          budget_s=args.budget_s, seed=args.seed,
                          device=args.device)
    if not card["ok"]:
        raise SystemExit(1)


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

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from .ops import (cuda_build, flash_attention_cuda, fusion_scan_cuda,
                          levenshtein_cuda)
        t0 = time.perf_counter()
        cuda_build.build_all([levenshtein_cuda.SOURCE,
                              flash_attention_cuda.SOURCE,
                              fusion_scan_cuda.SOURCE])
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
    if args.rawpose_batch:
        # the batched raw-pose GestureKNN search over the train database
        from .core.schemas import DatabaseBundle
        from .match.gesture_knn import (GestureKNNEngine,
                                        normalize_gesture_knn,
                                        stage_gesture_knn)
        C = args.rawpose_batch
        bundle = DatabaseBundle.load(args.train_database)
        gdb = stage_gesture_knn(bundle.mfcc, bundle.body)
        gdb_n, test_feat = normalize_gesture_knn(
            gdb, rng.randn(C, gdb.feat.shape[1], 14).astype(np.float32))
        gengine = GestureKNNEngine(gdb_n, device=dev)
        init = np.zeros((C,), np.int64)
        t0 = time.perf_counter()
        gengine.search_motion_batch(test_feat, init, init)
        print(f"raw-pose batch C={C}: first call "
              f"{time.perf_counter() - t0:7.1f} s")
    print(f"warm: {len(buckets)} bucket(s), preset {args.preset}"
          f"{', decode' if model is not None else ''}"
          f"{', serving' if pipeline is not None else ''}"
          + (f", {args.streams}-stream pool + solo session"
             if args.streams and cfg.chain_windows else "")
          + (f", raw-pose batch {args.rawpose_batch}"
             if args.rawpose_batch else ""))


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

    dev = resolve_device(args.device)
    if args.dataset == "trinity":
        from .pipelines.trinity import build_trinity_dataset
        if not (args.trn_path and args.val_path):
            raise SystemExit("--dataset trinity needs --trn-path and "
                             "--val-path (each holding Motion/ Audio/ "
                             "Transcripts/)")
        os.makedirs(args.out, exist_ok=True)
        paths = build_trinity_dataset(args.trn_path, args.val_path,
                                      mode=args.mode, fps=args.fps,
                                      out_dir=args.out, device=dev)
        for k, v in paths.items():
            print(f"wrote {k}: {v}")
        return
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
    if args.wavlm_checkpoint or args.w2v_bert_checkpoint:
        wavlm_model = _load_feature_encoder(args, dev)
        feat_name = "WavLM" if args.wavlm_checkpoint else "W2VBert"

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
            np.savez_compressed(f"{stem}_{feat_name}.npz", wavlm=feats)
            print(f"wrote {stem}_{feat_name}.npz: {feats.shape}")


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


def _train_dataset(path: str, conf):
    """A WindowedDataset directory, normalized with the config's statistics
    when it has them (else the directory's stats.npz, if any)."""
    from .train.data import WindowedDataset

    ds = WindowedDataset.load(path)
    if conf.data_mean is not None:
        ds.data_mean = np.asarray(conf.data_mean)
        ds.data_std = np.asarray(conf.data_std)
    return ds


@_in_group
def cmd_train_vqvae(args, dev):
    """train.py: the VQ-VAE on a WindowedDataset directory. Checkpoints go
    to <out>/best.pt (validated on the config's val_data_path, when it names
    one), latest.pt and {epoch:03d}.pt, the scalar history to
    <out>/scalars.jsonl; --resume continues from <out>/latest.pt. Under
    torch.distributed.run every rank walks the same batches and trains on
    its block of each; rank 0 writes, every rank reads --resume."""
    from .core.config import load_config
    from .parallel.dist import is_main
    from .train.checkpoints import checkpoint_path, restore_checkpoint
    from .train.train_vqvae import VQVAETrainer
    from .utils.metrics_log import ScalarHistory

    conf = load_config(args.config)
    ds = _train_dataset(args.data, conf)
    batches = list(ds.batches(conf.train.batch_size, seed=0))
    if not batches:
        raise SystemExit(f"{args.data}: {len(ds)} windows, fewer than one "
                         f"batch of {conf.train.batch_size}")
    val_batches = None
    if conf.val_data_path:
        val = _train_dataset(conf.val_data_path, conf)
        if conf.data_mean is None:
            val.data_mean, val.data_std = ds.data_mean, ds.data_std
        val_batches = list(val.batches(conf.train.batch_size, shuffle=False,
                                       drop_last=False))
    # the milestones are epochs (train.py:85): boundaries at m * batches
    trainer = VQVAETrainer(conf.vqvae, conf.train,
                           steps_per_epoch=len(batches), device=dev)
    trainer.init_codebook(batches[0])
    start_epoch = 1
    initial_best = None
    # an orbax 'latest' of the JAX trainer raises in restore_checkpoint
    if args.resume and (os.path.isfile(checkpoint_path(args.out, "latest"))
                        or os.path.isdir(os.path.join(args.out, "latest"))):
        trainer.load_state_dict(restore_checkpoint(args.out, "latest"))
        start_epoch = trainer.step // len(batches) + 1
        hist_path = os.path.join(args.out, "scalars.jsonl")
        if os.path.exists(hist_path):
            prior = ScalarHistory.last(hist_path, "best_val_err")
            if prior is not None:
                initial_best = (float(prior), 0)
        if is_main():
            print(f"resumed from {args.out}/latest.pt at epoch "
                  f"{start_epoch}")
    best = trainer.fit(batches, val_batches, epochs=args.epochs,
                       checkpoint_dir=args.out, start_epoch=start_epoch,
                       initial_best=initial_best)
    if is_main():
        print(f"best val: {best}")


@_in_group
def cmd_train_pae(args, dev):
    """PAE.py --stage train on a WindowedDataset directory; {epoch:03d}.pt
    every save_per_epochs and latest.pt at the end in --out. Under
    torch.distributed.run every rank walks the same batches and trains on
    its block of each; rank 0 writes."""
    from .core.config import load_config
    from .train.checkpoints import save_checkpoint
    from .train.data import device_prefetch
    from .train.train_pae import PAETrainer
    from .utils.metrics_log import ScalarHistory

    conf = load_config(args.config)
    ds = _train_dataset(args.data, conf)
    batches = list(ds.batches(max(args.batch_size, 8), seed=0))
    trainer = PAETrainer(conf.pae, steps_per_epoch=max(len(batches), 1),
                         device=dev)
    out = args.out if trainer.writes else None
    epochs = args.epochs or conf.pae.epochs
    hist = ScalarHistory(os.path.join(out, "scalars.jsonl")) if out else None
    try:
        for epoch in range(epochs):
            for block in device_prefetch(map(trainer.shard, batches), dev):
                loss = trainer.train_block(block)
            loss_v = float(loss)
            if trainer.writes:
                print(f"epoch {epoch}: loss {loss_v:.5f}")
            if hist:
                hist.log(epoch=epoch, loss=loss_v)
            if out and (epoch + 1) % conf.pae.save_per_epochs == 0:
                save_checkpoint(out, trainer.state_dict(epoch),
                                name=f"{epoch:03d}")
    finally:
        if hist:
            hist.close()
    if out:
        save_checkpoint(out, trainer.state_dict(epochs - 1), name="latest")


@_in_group
def cmd_train_end2end(args, dev):
    """end2end.py: the GRU baseline on a WindowedDataset directory holding
    audio.npy and codes.npy; latest.pt at the end in --out. Under
    torch.distributed.run every rank walks the same batches and trains on
    its block of each; rank 0 writes."""
    from .core.config import load_config
    from .train.checkpoints import save_checkpoint
    from .train.data import device_prefetch
    from .train.train_end2end import End2EndTrainer
    from .utils.metrics_log import ScalarHistory

    conf = load_config(args.config)
    ds = _train_dataset(args.data, conf)
    if ds.audio is None or ds.codes is None:
        raise SystemExit(f"{args.data}: end2end training needs audio.npy "
                         "and codes.npy in the dataset")
    trainer = End2EndTrainer(conf.end2end, device=dev)
    out = args.out if trainer.writes else None
    epochs = args.epochs or conf.end2end.epochs
    hist = ScalarHistory(os.path.join(out, "scalars.jsonl")) if out else None
    try:
        for epoch in range(epochs):
            for wav, codes in device_prefetch(map(trainer.shard, ds.batches(
                    args.batch_size, seed=epoch,
                    include=("audio", "codes"))), dev):
                loss = trainer.train_block(wav, codes)
            loss_v = float(loss)
            if trainer.writes:
                print(f"epoch {epoch}: loss {loss_v:.5f}")
            if hist:
                hist.log(epoch=epoch, loss=loss_v)
    finally:
        if hist:
            hist.close()
    if out:
        save_checkpoint(out, trainer.state_dict(epochs - 1), name="latest")


def _load_motion(path: str) -> np.ndarray:
    """evaluate's inputs: .npy, or an npz holding poses / body / motion."""
    if path.endswith(".npy"):
        return np.load(path)
    data = np.load(path, allow_pickle=True)
    for key in ("poses", "body", "motion"):
        if key in data.files:
            return data[key]
    raise ValueError(f"{path}: no poses/body/motion array")


def cmd_evaluate(args):
    """Score generated motion against ground truth: Hellinger distance over
    velocity histograms and FGD (raw space on the host; feature space with
    the trained extractor of --fgd-extractor and/or the VQ-VAE's encoder
    codes, each encoding on --device). Inputs are npz files with a poses /
    body / motion array or .npy, of shape (T, C) or (N, T, C). Prints one
    JSON line, the JAX package's."""
    import json
    import sys

    import torch

    from .device import resolve_device
    from .render.metrics import fgd, hellinger_velocity

    dev = resolve_device(args.device)
    gen = _load_motion(args.generated)
    ref = _load_motion(args.reference)
    flat_gen = gen.reshape(-1, gen.shape[-1])
    flat_ref = ref.reshape(-1, ref.shape[-1])
    out = {"hellinger": round(hellinger_velocity(flat_gen, flat_ref), 6)}

    win = args.window

    def windows(x):
        n = (x.shape[0] // win) * win
        return x[:n].reshape(-1, win, x.shape[-1])

    wg, wr = windows(flat_gen), windows(flat_ref)
    out["fgd_raw"] = round(fgd(wg, wr), 4)

    if args.vqvae_checkpoint:
        from .core.config import VQVAEConfig, load_config
        conf = load_config(args.config) if args.config else None
        model = _load_vqvae(args.vqvae_checkpoint,
                            conf.vqvae if conf else VQVAEConfig(), dev)
        # the encoder was trained on z-normalized windows (encode_windows)
        mean = np.asarray(conf.data_mean, np.float32) \
            if conf and conf.data_mean is not None else None
        std = np.clip(np.asarray(conf.data_std, np.float32), 0.01, None) \
            if conf and conf.data_std is not None else None
        if mean is None:
            print("warning: no data_mean/data_std in --config; "
                  "fgd_feature encodes un-normalized windows",
                  file=sys.stderr)

        @torch.no_grad()
        def encoder(wins):
            w = wins.astype(np.float32)
            if mean is not None:
                w = (w - mean) / std
            zs = model.encode(torch.from_numpy(w).to(dev)).cpu().numpy()
            return zs.reshape(zs.shape[0], -1).astype(np.float64)

        out["fgd_vqvae_latent" if args.fgd_extractor else "fgd_feature"] \
            = round(fgd(wg, wr, encoder=encoder), 4)

    if args.fgd_extractor:
        # the paper's protocol (FGD-feat): a dedicated motion autoencoder
        # trained on ground truth (the train-fgd CLI)
        from .render.fgd_extractor import fgd_encoder_fn, load_fgd_extractor
        model, mean, std = load_fgd_extractor(args.fgd_extractor, device=dev)
        if wg.shape[1] != model.cfg.window:
            raise SystemExit(
                f"--window {wg.shape[1]} != extractor window "
                f"{model.cfg.window}; pass --window {model.cfg.window}")
        out["fgd_feature"] = round(fgd(wg, wr, encoder=fgd_encoder_fn(
            model, mean, std)), 4)
    print(json.dumps(out))


def cmd_train_fgd(args):
    """Train the feature-space FGD extractor on ground-truth motion (the
    Yoon et al. embedding-net protocol) on --device."""
    from .device import resolve_device
    from .render.fgd_extractor import (FGDExtractorConfig,
                                       save_fgd_extractor,
                                       train_fgd_extractor)

    dev = resolve_device(args.device)
    if os.path.isdir(args.data):
        from .train.data import WindowedDataset
        wins = WindowedDataset.load(args.data).poses
    else:
        data = np.load(args.data, allow_pickle=True)
        if isinstance(data, np.ndarray):
            wins = data
        else:
            key = next((k for k in ("body", "poses", "motion")
                        if k in data.files), None)
            if key is None:
                raise SystemExit(f"{args.data}: no body/poses/motion array")
            wins = data[key]
    if wins.ndim == 2:
        n = (wins.shape[0] // args.window) * args.window
        wins = wins[:n].reshape(-1, args.window, wins.shape[-1])
    cfg = FGDExtractorConfig(channels=wins.shape[-1], window=wins.shape[1],
                             latent=args.latent)
    model, mean, std = train_fgd_extractor(
        wins, cfg, epochs=args.epochs, batch_size=args.batch_size,
        seed=args.seed, device=dev)
    save_fgd_extractor(args.out, model, mean, std)
    print(f"wrote {args.out}: latent={cfg.latent} window={cfg.window} "
          f"({wins.shape[0]} training windows)")


def cmd_train_resync(args):
    """ResyncNet WGAN-GP training (train_resync_gestureknn.py:108-187) on an
    npz holding knn / real as (N, T, n_mfcc + n_joints): KNN-searched motion
    windows with their audio features, and ground-truth windows. Batches
    are the JAX package's (np.random.RandomState(0).randint); the losses are
    read on the host only every iters // 10 iterations; --out writes
    <out>/latest.pt."""
    from .core.config import ResyncConfig, load_config
    from .device import resolve_device, to_device
    from .train.checkpoints import save_checkpoint
    from .train.train_resync import ResyncTrainer

    dev = resolve_device(args.device)
    conf = load_config(args.config) if args.config else None
    cfg = conf.resync if conf and getattr(conf, "resync", None) \
        else ResyncConfig()
    data = np.load(args.data)
    x_knn = data["knn"].astype(np.float32)
    x_real = data["real"].astype(np.float32)
    if x_knn.shape != x_real.shape:
        raise SystemExit(f"{args.data}: knn {x_knn.shape} and real "
                         f"{x_real.shape} differ")
    n, t, c = x_knn.shape
    trainer = ResyncTrainer(cfg, n_mfcc=c - args.n_joints,
                            n_joints=args.n_joints, num_frames=t, device=dev)
    # the whole set on the device once; each batch a gather there
    knn_d, real_d = to_device(x_knn, dev), to_device(x_real, dev)
    rng = np.random.RandomState(0)
    iters = args.iters or cfg.max_iters
    bs = min(args.batch_size or cfg.batch_size, n)
    for it in range(iters):
        idx = to_device(rng.randint(0, n, size=bs), dev)
        logs = trainer.train_iteration(knn_d[idx], real_d[idx], it)
        if it % max(1, iters // 10) == 0:
            print(f"iter {it}: " + " ".join(f"{k} {float(v):.4f}"
                                            for k, v in logs.items()))
    if args.out:
        save_checkpoint(args.out, trainer.state_dict(), name="latest")
        print(f"saved {args.out}")


def cmd_plot(args):
    """Offline training plots (the reference's live matplotlib windows,
    Library/Utility.py:21-75 + Plotting.py): loss/metric curves from a
    scalars.jsonl history and/or a phase-manifold PCA from a Phase npz."""
    from .core import constants as C
    from .render.plots import (plot_phase_channels, plot_phase_manifold,
                               plot_scalar_history, plot_wav_debug)

    os.makedirs(args.out, exist_ok=True)
    wrote = []
    if args.history:
        wrote.append(plot_scalar_history(
            args.history, os.path.join(args.out, "scalars.png"),
            tags=args.tags))
    if args.phase:
        from .core.schemas import _to_dense_phase
        data = np.load(args.phase, allow_pickle=True)
        key = "phase" if "phase" in data.files else data.files[0]
        phase = _to_dense_phase(data[key])
        if args.phase_debug:
            # per-channel Phase2D_mono curves over random 32-frame
            # windows (visualize_phase.py:64-83: one window, then a
            # 3-window overlay)
            seqs = phase if phase.ndim == 4 else phase[None]
            rng = np.random.RandomState(args.seed)
            win = min(32, seqs.shape[1])

            def pick():
                i = rng.randint(0, seqs.shape[0])
                j = rng.randint(0, max(1, seqs.shape[1] - win + 1))
                return seqs[i, j:j + win]
            wrote.append(plot_phase_channels(
                [pick()], os.path.join(args.out, "visualize_phase.png")))
            wrote.append(plot_phase_channels(
                [pick() for _ in range(3)],
                os.path.join(args.out, "visualize_phase_3.png")))
        flat = phase.reshape(-1, *phase.shape[-2:]) if phase.ndim == 4 \
            else phase
        wrote.append(plot_phase_manifold(
            flat, os.path.join(args.out, "phase_manifold.png")))
    if args.wav:
        if args.wav.endswith(".npz"):
            wav = np.load(args.wav)["wav"].astype(np.float32).reshape(-1)
        else:
            from .pipelines.audio_prep import load_wav_16k
            wav = load_wav_16k(args.wav)
        wrote.append(plot_wav_debug(
            wav, C.SR, os.path.join(args.out, "wav_debug.png")))
    if args.merge_figs:
        from .render.plots import merge_frames
        wrote.append(merge_frames(
            args.merge_figs, os.path.join(args.out, "merged_figs.mp4"),
            count=args.count, fps=args.fps))
    if not wrote:
        raise SystemExit("pass --history, --phase, --wav and/or "
                         "--merge-figs")
    for w in wrote:
        print(f"wrote {w}")


def cmd_bench(args):
    from .bench import run
    return run(args)


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
                   help="audio feature-DB residency dtype (bf16/f16 halve "
                        "the resident database; cosine presets only, the "
                        "wavvq strings ignore it)")
    m.add_argument("--max-frames", type=int, default=0)
    m.add_argument("--ties", default="stable",
                   choices=["stable", "reference"],
                   help="tie policy: 'stable' (deterministic, all-device) "
                        "or 'reference' (bit-parity with the original "
                        "binary's unstable introsort + f64 rank sums; "
                        "phase 1 on the device, the fusion on the host)")
    m.add_argument("--sharded", default="auto",
                   choices=["auto", "never", "always"],
                   help="database sharding over the ranks of a "
                        "torch.distributed.run launch (a lone process is a "
                        "world of one): 'auto' spills to the J-sharded path "
                        "when the staged database would exceed ~60%% of one "
                        "card's memory and there is more than one rank "
                        "(QPG_HBM_BYTES overrides the card's report); "
                        "'always' shards; results are bit-identical")
    m.add_argument("--device", default="cuda",
                   help="torch device (default cuda: cuda:{LOCAL_RANK} "
                        "under torch.distributed.run; raises without a GPU)")
    m.add_argument("--dist-backend", choices=["nccl", "gloo"],
                   help="torch.distributed backend under "
                        "torch.distributed.run (default: nccl on CUDA, gloo "
                        "on the CPU; gloo for ranks sharing one card)")
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
                        "'end2end' = the w/o-motion-matching GRU baseline "
                        "(codebook/inference.py)")
    g.add_argument("--train-database",
                   help="required for --model matching (and for --resync)")
    g.add_argument("--train-codebook")
    g.add_argument("--codebook-signature")
    g.add_argument("--train-wavlm")
    g.add_argument("--train-wavvq")
    g.add_argument("--wavvq-checkpoint",
                   help="fairseq vq-wav2vec .pt (--preset wavvq)")
    g.add_argument("--wavlm-checkpoint",
                   help="Microsoft WavLM .pt (every preset but wavvq; or "
                        "--w2v-bert-checkpoint)")
    g.add_argument("--w2v-bert-checkpoint",
                   help="w2v-BERT 2.0 in transformers' layout (a directory "
                        "with config.json and model.safetensors) or a "
                        "state-dict file: the 50 Hz feature encoder in "
                        "place of WavLM")
    g.add_argument("--end2end-checkpoint", metavar="CKPT",
                   help="reference Generator_gru weights (end2end_*.bin) "
                        "or a train-end2end output directory (its "
                        "latest.pt) for --model end2end")
    g.add_argument("--max-frames", type=int, default=0,
                   help="clamp end2end generation length "
                        "(inference.py MAX_FRAMES)")
    g.add_argument("--vqvae-checkpoint", required=True)
    g.add_argument("--pipeline", required=True,
                   help="MotionPipeline JSON snapshot")
    g.add_argument("--config")
    g.add_argument("--preset", default="wavvq", choices=PRESET_CHOICES,
                   help="match preset: wavvq presets encode with "
                        "vq-wav2vec, every other with WavLM or w2v-BERT")
    g.add_argument("--out", default="./output")
    g.add_argument("--prefix", default="generated")
    g.add_argument("--smooth", action="store_true")
    g.add_argument("--video", action="store_true",
                   help="also render a stick-figure video of the motion "
                        "(mp4 with ffmpeg, else GIF, else PNG frames; "
                        "needs matplotlib)")
    g.add_argument("--resync", metavar="CKPT",
                   help="apply a trained ResyncNet to the decoded motion "
                        "(reference best_model.pth or a train-resync "
                        "output directory)")
    g.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU)")
    g.set_defaults(fn=cmd_generate)

    ra = sub.add_parser(
        "resync-apply",
        help="stage-2 ResyncNet application to KNN output "
             "(ResyncGestureKNN.py:43-87)")
    ra.add_argument("--knn", required=True,
                    help="npz with knn_pred (N, J, T) motion")
    ra.add_argument("--test-data", required=True,
                    help="npz with test 'mfcc' (N, T, >=13)")
    ra.add_argument("--train-database", required=True,
                    help="npz with train 'mfcc' + 'body' (the stats "
                         "source, ResyncGestureKNN.main:126-137)")
    ra.add_argument("--checkpoint", required=True)
    ra.add_argument("--out", required=True)
    ra.add_argument("--frames", type=int, default=0,
                    help="resync only the first N sequences (0 = all; "
                         "the reference's frames arg)")
    ra.add_argument("--layout", choices=("njt", "ntj"), default="njt")
    ra.add_argument("--n-mfcc", type=int, default=13)
    ra.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a GPU)")
    ra.set_defaults(fn=cmd_resync_apply)

    vr = sub.add_parser(
        "verify-release",
        help="one-command acceptance gate on the reference's published "
             "artifact tree (README quick start layout)")
    vr.add_argument("root", help="artifact root containing data/ and "
                                 "pretrained_model/")
    vr.add_argument("--expected",
                    help="result.npz produced by the original reference "
                         "binary, for byte-exact index parity")
    vr.add_argument("--config", help="codebook.yml for the VQ-VAE shape "
                                     "and data mean/std")
    vr.add_argument("--out", help="write the gate's result.npz here")
    vr.add_argument("--budget-s", type=float, default=5.0,
                    help="wall-clock budget for the warm quick-start match")
    vr.add_argument("--subsample", type=int, default=8,
                    help="database sequences for the exact-parity harness")
    vr.add_argument("--seed", type=int,
                    help="override the match rng seed (the reference pins "
                         "123456 at import, GestureKNN.py:19-22)")
    for k in ("train-db", "test-db", "train-code", "signature",
              "train-wavlm", "test-wavlm", "train-wavvq", "test-wavvq",
              "checkpoint"):
        vr.add_argument(f"--{k}", help=f"override the {k} artifact path")
    vr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a GPU)")
    vr.set_defaults(fn=cmd_verify_release)

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
                    help="feature-DB residency dtype (match the production "
                         "--feat-dtype)")
    wu.add_argument("--streams", type=int, default=0,
                    help="also run one StreamingPool tick for this many "
                         "streams, and one solo StreamingSession push")
    wu.add_argument("--rawpose-batch", type=int, default=0,
                    help="also run the batched raw-pose GestureKNN search "
                         "for this many clips")
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
                    help="'trinity' = Trinity/GENEA2020 training-store "
                         "builder (trinity_data_to_lmdb.py equivalent; "
                         "uses --trn-path/--val-path/--mode)")
    bd.add_argument("--bvh-dir")
    bd.add_argument("--wav-dir")
    bd.add_argument("--transcript-dir")
    bd.add_argument("--trn-path", help="trinity: training split dir "
                                       "(Motion/ Audio/ Transcripts/)")
    bd.add_argument("--val-path", help="trinity: test split dir")
    bd.add_argument("--mode", default="rotation",
                    choices=["rotation", "position"],
                    help="trinity: pose parameterization")
    bd.add_argument("--out", required=True)
    bd.add_argument("--prefix", default="speaker")
    bd.add_argument("--fps", type=int, default=60)
    bd.add_argument("--n-frames", type=int, default=240)
    bd.add_argument("--config")
    bd.add_argument("--vqvae-checkpoint")
    bd.add_argument("--wavvq-checkpoint")
    bd.add_argument("--wavlm-checkpoint")
    bd.add_argument("--w2v-bert-checkpoint",
                    help="w2v-BERT 2.0 (transformers' layout or a state "
                         "dict) in place of WavLM: its features are written "
                         "as <prefix>_<split>_<frames>_W2VBert.npz under the "
                         "key wavlm, which --train-wavlm reads")
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

    tv = sub.add_parser("train-vqvae", help="train the gesture VQ-VAE")
    tv.add_argument("--config", required=True)
    tv.add_argument("--data", required=True,
                    help="WindowedDataset directory")
    tv.add_argument("--out", default="./output/train_codebook")
    tv.add_argument("--epochs", type=int)
    tv.add_argument("--resume", action="store_true",
                    help="resume from <out>/latest.pt if present")
    tv.add_argument("--device", default="cuda",
                    help="torch device (default cuda: cuda:{LOCAL_RANK} "
                         "under torch.distributed.run; raises without a "
                         "GPU)")
    tv.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    help="torch.distributed backend under "
                         "torch.distributed.run: the ranks split every "
                         "batch (default: nccl on CUDA, gloo on the CPU)")
    tv.set_defaults(fn=cmd_train_vqvae)

    tp = sub.add_parser("train-pae", help="train the periodic autoencoder")
    tp.add_argument("--config", required=True)
    tp.add_argument("--data", required=True)
    tp.add_argument("--out")
    tp.add_argument("--epochs", type=int)
    tp.add_argument("--batch-size", type=int, default=32)
    tp.add_argument("--device", default="cuda",
                    help="torch device (default cuda: cuda:{LOCAL_RANK} "
                         "under torch.distributed.run; raises without a "
                         "GPU)")
    tp.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    help="torch.distributed backend under "
                         "torch.distributed.run: the ranks split every "
                         "batch (default: nccl on CUDA, gloo on the CPU)")
    tp.set_defaults(fn=cmd_train_pae)

    te = sub.add_parser("train-end2end", help="train the GRU baseline")
    te.add_argument("--config", required=True)
    te.add_argument("--data", required=True)
    te.add_argument("--out")
    te.add_argument("--epochs", type=int)
    te.add_argument("--batch-size", type=int, default=32)
    te.add_argument("--device", default="cuda",
                    help="torch device (default cuda: cuda:{LOCAL_RANK} "
                         "under torch.distributed.run; raises without a "
                         "GPU)")
    te.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    help="torch.distributed backend under "
                         "torch.distributed.run: the ranks split every "
                         "batch (default: nccl on CUDA, gloo on the CPU)")
    te.set_defaults(fn=cmd_train_end2end)

    pl = sub.add_parser("plot", help="training curves / phase-manifold / "
                        "phase+audio debug PNGs")
    pl.add_argument("--history", help="scalars.jsonl path")
    pl.add_argument("--phase", help="Phase npz (dense or object format)")
    pl.add_argument("--phase-debug", action="store_true",
                    help="also render per-channel Phase2D_mono curve "
                         "grids over random 32-frame windows "
                         "(visualize_phase.py:34-83)")
    pl.add_argument("--wav", help="wav/npz for time+frequency-domain "
                    "debug views (visualize_phase.py:13-31)")
    pl.add_argument("--seed", type=int, default=0,
                    help="window picker seed for --phase-debug")
    pl.add_argument("--tags", nargs="*")
    pl.add_argument("--merge-figs", metavar="PATTERN",
                    help="stitch a numbered image sequence into a video "
                         "(merge_figs.py:5-15); format string with one "
                         "{} slot, e.g. 'figs/{}.jpg'")
    pl.add_argument("--count", type=int, default=20,
                    help="frame count for --merge-figs")
    pl.add_argument("--fps", type=int, default=30,
                    help="frame rate for --merge-figs")
    pl.add_argument("--out", default="./plots")
    pl.set_defaults(fn=cmd_plot)

    ev = sub.add_parser("evaluate",
                        help="Hellinger + FGD between motion sets")
    ev.add_argument("--generated", required=True)
    ev.add_argument("--reference", required=True)
    ev.add_argument("--window", type=int, default=240)
    ev.add_argument("--vqvae-checkpoint")
    ev.add_argument("--fgd-extractor",
                    help="trained FGD feature extractor (train-fgd CLI) "
                         "for the paper's feature-space FGD")
    ev.add_argument("--config")
    ev.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a GPU)")
    ev.set_defaults(fn=cmd_evaluate)

    tf = sub.add_parser("train-fgd",
                        help="train the feature-space FGD extractor")
    tf.add_argument("--data", required=True,
                    help="ground-truth windows: npz with body/poses, .npy, "
                         "or a WindowedDataset dir")
    tf.add_argument("--out", required=True)
    tf.add_argument("--window", type=int, default=240,
                    help="window length when --data holds flat (T, C)")
    tf.add_argument("--latent", type=int, default=32)
    tf.add_argument("--epochs", type=int, default=20)
    tf.add_argument("--batch-size", type=int, default=64)
    tf.add_argument("--seed", type=int, default=0)
    tf.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a GPU)")
    tf.set_defaults(fn=cmd_train_fgd)

    tr = sub.add_parser("train-resync",
                        help="train the ResyncNet WGAN-GP refiner")
    tr.add_argument("--data", required=True,
                    help="npz with knn/real (N, T, n_mfcc+n_joints) arrays")
    tr.add_argument("--config")
    tr.add_argument("--n-joints", type=int, default=135)
    tr.add_argument("--iters", type=int)
    tr.add_argument("--batch-size", type=int)
    tr.add_argument("--out")
    tr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a GPU)")
    tr.set_defaults(fn=cmd_train_resync)

    from .bench import add_arguments as bench_arguments
    b = sub.add_parser("bench", help="the headline benchmark on one CUDA "
                                     "card (no --device: it measures the "
                                     "card)")
    bench_arguments(b)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
