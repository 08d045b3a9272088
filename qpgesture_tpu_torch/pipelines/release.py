"""verify-release: the one-command acceptance gate for real artifacts.

The port of ``qpgesture_tpu/pipelines/release.py``. The reference's quick
start (README.md:27-44, GestureKNN.sh:1-18) runs on a downloadable tree:

    <root>/data/BEAT/speaker_S_state_T/
        speaker_S_state_T_{train,test}_240_txt_2.npz
        speaker_S_state_T_train_240_code.npz
        speaker_S_state_T_{train,test}_240_WavLM.npz
        speaker_S_state_T_train_240_WavVQ.npz
    <root>/data/BEAT/BEAT_output_60fps_rotation/code.npz
    <root>/data/**/wavvq_240.npz             (the 24 s demo clip)
    <root>/pretrained_model/codebook_checkpoint_best.bin

``python -m qpgesture_tpu_torch verify-release <root>`` consumes that layout
verbatim and asserts, in one run on ``device`` (default ``cuda``):

  1. every artifact loads through the reference-format readers (including
     object-dtype phase arrays and the EasyDict/DataParallel .bin);
  2. the wavvq quick-start match completes within the budget (5 s wall by
     default), timed on the second ``predict``: the first builds the CUDA
     kernels at first use; the timed call returns host arrays, so its
     window includes the device sync;
  3. exact-parity harness: on a database subsample, the engine's
     reference-ties mode bit-matches the host oracle running the
     reference's own arithmetic;
  4. (``expected``) byte-exact index parity against a result produced by
     the original reference binary, when the user has one;
  5. the result decodes through the checkpoint to (W*240, 135) poses.

Every gate keeps the JAX package's name and JSON shape. Prints the JSON
scorecard; the CLI exits non-zero on any failed gate.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from typing import Optional

import numpy as np

from ..device import DeviceLike, resolve_device


def _find_one(patterns, root) -> Optional[str]:
    for pat in patterns:
        hits = sorted(glob.glob(os.path.join(root, pat), recursive=True))
        if hits:
            return hits[0]
    return None


def resolve_artifacts(root: str, overrides: Optional[dict] = None) -> dict:
    """Locate the published artifact layout under ``root``. Any entry can be
    overridden by an explicit path."""
    overrides = {k: v for k, v in (overrides or {}).items() if v}
    speaker_dir = None
    for cand in sorted(glob.glob(os.path.join(
            root, "data", "BEAT", "speaker_*_state_*"))):
        if os.path.isdir(cand):
            speaker_dir = cand
            break
    paths = {}
    if speaker_dir:
        prefix = os.path.basename(speaker_dir)

        def sp(name):
            p = os.path.join(speaker_dir, f"{prefix}_{name}.npz")
            return p if os.path.exists(p) else None
        paths.update(
            train_db=sp("train_240_txt_2"), test_db=sp("test_240_txt_2"),
            train_code=sp("train_240_code"),
            train_wavlm=sp("train_240_WavLM"),
            test_wavlm=sp("test_240_WavLM"),
            train_wavvq=sp("train_240_WavVQ"))
    paths.setdefault("train_db", None)
    paths["signature"] = _find_one(
        ["data/BEAT/BEAT_output_60fps_rotation/code.npz",
         "data/**/code.npz"], root)
    paths["test_wavvq"] = _find_one(["data/**/wavvq_240.npz"], root)
    paths["checkpoint"] = _find_one(
        ["pretrained_model/codebook_checkpoint_best.bin",
         "pretrained_model/**/*.bin"], root)
    paths.update(overrides)
    return paths


def verify_release(root: str, overrides: Optional[dict] = None,
                   expected: Optional[str] = None,
                   config: Optional[str] = None,
                   out: Optional[str] = None,
                   subsample: int = 8,
                   budget_s: float = 5.0,
                   seed: Optional[int] = None,
                   device: DeviceLike = "cuda") -> dict:
    """Run the acceptance gate. Returns the scorecard dict (also printed);
    scorecard['ok'] is the overall verdict."""
    import torch

    from ..core.config import MATCH_PRESETS, MatchConfig, VQVAEConfig, \
        load_config
    from ..core.schemas import (CodebookSignature, DatabaseBundle,
                                load_codes, load_wavvq, save_result)
    from ..match.database import (stage_database, stage_test_audio,
                                  stage_test_context)
    from ..match.engine import CodeKNNEngine
    from ..match.oracle import CodeKNNOracle
    from ..models.convert import load_vqvae_checkpoint

    dev = resolve_device(device)
    card = {"root": os.path.abspath(root), "checks": {}, "ok": True}

    def gate(name, ok, detail=None):
        card["checks"][name] = {"ok": bool(ok)}
        if detail is not None:
            card["checks"][name]["detail"] = detail
        if not ok:
            card["ok"] = False

    paths = resolve_artifacts(root, overrides)
    card["artifacts"] = paths
    required = ["train_db", "test_db", "train_code", "signature",
                "train_wavvq", "test_wavvq", "checkpoint"]
    missing = [k for k in required if not paths.get(k)]
    gate("artifacts_present", not missing,
         {"missing": missing} if missing else "all found")
    if missing:
        print(json.dumps(card, indent=2))
        return card

    # 1. reference-format loads -------------------------------------------
    try:
        bundle = DatabaseBundle.load(paths["train_db"])
        test_bundle = DatabaseBundle.load(paths["test_db"])
        codes = load_codes(paths["train_code"])
        signature = CodebookSignature.load(paths["signature"])
        train_wavvq = load_wavvq(paths["train_wavvq"])
        test_wavvq = load_wavvq(paths["test_wavvq"])
        gate("formats_load", True,
             {"db_windows": int(codes.shape[0]),
              "test_windows": int(test_wavvq.shape[0])})
    except Exception as e:  # noqa: BLE001 — the gate reports, not raises
        gate("formats_load", False, repr(e))
        print(json.dumps(card, indent=2))
        return card

    # 2. checkpoint load + decode path ------------------------------------
    vq_cfg = load_config(config).vqvae if config else VQVAEConfig()
    try:
        model = load_vqvae_checkpoint(paths["checkpoint"], vq_cfg,
                                      device=dev)
        gate("checkpoint_loads", True)
    except Exception as e:  # noqa: BLE001
        gate("checkpoint_loads", False, repr(e))
        model = None

    # 3. the wavvq quick-start match ---------------------------------------
    preset = MATCH_PRESETS["wavvq"].__dict__
    cfg = MatchConfig(**{**preset,
                         "codebook_size": signature.signature.shape[0],
                         **({"seed": seed} if seed is not None else {})})
    db = stage_database(cfg, bundle, codes, signature, wavvq=train_wavvq)
    test_audio = stage_test_audio(cfg, db, wavvq=test_wavvq)
    if test_bundle.context is None:
        gate("test_context_present", False, "test bundle has no context")
        print(json.dumps(card, indent=2))
        return card
    test_ctx = stage_test_context(db, test_bundle.context)

    engine = CodeKNNEngine(cfg, db, device=dev)
    # the first call builds the kernels (nvcc) at first use
    result = engine.predict(test_audio, test_ctx,
                            rng=np.random.RandomState(cfg.seed))
    t0 = time.perf_counter()
    result = engine.predict(test_audio, test_ctx,
                            rng=np.random.RandomState(cfg.seed))
    wall = time.perf_counter() - t0
    gest_s = test_audio.shape[0] * 4.0
    gate("wall_under_budget", wall < budget_s,
         {"wall_s": round(wall, 3), "budget_s": budget_s,
          "gest_s_per_s": round(gest_s / wall, 1)})

    ref_ties = engine.predict_reference_ties(
        test_audio, test_ctx, rng=np.random.RandomState(cfg.seed))
    agree = float((result.codes == ref_ties.codes).mean())
    card["stable_vs_reference_tie_agreement"] = round(agree, 4)

    # 4. exact-parity harness on a database subsample ----------------------
    sub = min(subsample, codes.shape[0])
    db_s = stage_database(cfg, _take_bundle(bundle, sub), codes[:sub],
                          signature, wavvq=train_wavvq[:sub])
    eng_s = CodeKNNEngine(cfg, db_s, device=dev)
    ta_s = test_audio[:2]
    tc_s = test_ctx[:2]
    got = eng_s.predict_reference_ties(
        ta_s, tc_s, rng=np.random.RandomState(cfg.seed))
    want = CodeKNNOracle(db_s, tie_kind="reference").predict(
        ta_s, tc_s, rng=np.random.RandomState(cfg.seed))
    gate("subsample_reference_parity",
         bool((got.codes == want.codes).all()),
         {"subsample_seqs": sub, "windows": int(ta_s.shape[0])})

    # 5. optional byte-exact parity vs a reference-binary result -----------
    if expected:
        from ..core.schemas import load_result
        exp = load_result(expected)
        same = exp.shape == result.codes.shape and \
            bool((exp == ref_ties.codes).all())
        gate("expected_result_parity", same,
             {"expected": expected,
              "note": "compared against reference-ties mode output"})

    # 6. decode ------------------------------------------------------------
    if model is not None:
        flat = torch.as_tensor(
            np.asarray(ref_ties.codes).reshape(1, -1).astype(np.int64),
            device=dev)
        poses = model.decode(flat).cpu().numpy()
        W = ref_ties.codes.shape[0]
        gate("decode_shapes", poses.shape == (1, W * 240, vq_cfg.input_dim),
             {"poses": list(poses.shape)})

    if out:
        save_result(out, ref_ties.codes)
        card["result"] = out
    print(json.dumps(card, indent=2))
    return card


def _take_bundle(bundle, n: int):
    """First-n-sequences view of a DatabaseBundle (for the subsample
    harness)."""
    fields = {}
    for f in dataclasses.fields(bundle):
        v = getattr(bundle, f.name)
        fields[f.name] = v[:n] if isinstance(v, np.ndarray) and \
            v.ndim >= 1 and v.shape[0] >= n else v
    return dataclasses.replace(bundle, **fields)
