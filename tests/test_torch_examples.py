"""The port's examples (qpgesture_tpu_torch/examples/) against the JAX
package's scripts in examples/ on the same seeded inputs, on the CPU.
Integer outputs (codes, mismatch counts, tie fractions, byte counts) are
compared exactly; the raw-pose search's motion within GESTURE_ATOL."""
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from qpgesture_tpu.core.config import MATCH_PRESETS as JAX_PRESETS
from qpgesture_tpu.core.config import MatchConfig as JaxMatchConfig
from qpgesture_tpu.match.database import stage_database as jax_stage_db
from qpgesture_tpu.match.database import \
    stage_test_audio as jax_stage_audio
from qpgesture_tpu.match.database import \
    stage_test_context as jax_stage_context
from qpgesture_tpu.match.engine import CodeKNNEngine as JaxEngine
from qpgesture_tpu_torch import bench as port_bench
from qpgesture_tpu_torch.core.config import VQVAEConfig
from qpgesture_tpu_torch.examples import (chip_parity_sweep, demo_synthetic,
                                          fixtures, parity_soak,
                                          rawwav_latency, scale_study,
                                          serve_production, streaming_soak,
                                          tie_divergence_sweep,
                                          train_campaign)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GESTURE_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite's parallel
    workers share the cores, and torch's thread pool in each of them
    oversubscribes them (the campaign and serving cases ran 10-20 times
    slower so). Put back afterwards for the worker's other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
_JAX_CACHE_KEYS = ("jax_compilation_cache_dir",
                   "jax_persistent_cache_min_compile_time_secs")


def _jax_example(name):
    """examples/<name>.py of the JAX package as a module. The scripts put
    the repo root and tests/ on sys.path and some point JAX's compile cache
    at the repo root: both are put back."""
    path = os.path.join(REPO, "examples", f"{name}.py")
    saved_path = list(sys.path)
    saved_cfg = {k: getattr(jax.config, k) for k in _JAX_CACHE_KEYS}
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved_path
        for k, v in saved_cfg.items():
            jax.config.update(k, v)
    return mod


def _assert_tree_equal(a, b, what):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_tree_equal(getattr(a, f.name), getattr(b, f.name),
                               f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)
    else:
        assert a == b, what


# ---- fixtures ---------------------------------------------------------------

def _jax_helper(name):
    """The JAX package's test helper ``name`` (tests/ is on sys.path)."""
    if name == "make_fixture":
        from fixtures import make_fixture
        return make_fixture
    if name == "make_long_fixture":
        from test_match_parity import _make_long_fixture
        return _make_long_fixture
    from test_build_db_cli import make_beat_like_bvh
    return make_beat_like_bvh


@pytest.mark.parametrize("seed", [0, 3600])
@pytest.mark.parametrize("name", ["make_fixture", "make_long_fixture",
                                  "make_beat_like_bvh"])
def test_fixtures_equal_the_jax_helpers(name, seed):
    args = (37,) if name == "make_beat_like_bvh" else ()
    r_port, r_jax = np.random.RandomState(seed), np.random.RandomState(seed)
    _assert_tree_equal(getattr(fixtures, name)(r_port, *args),
                       _jax_helper(name)(r_jax, *args), name)
    # and the generators end in the same state
    np.testing.assert_array_equal(r_port.randn(3), r_jax.randn(3))


# ---- the parity soak, the sweep's extras, the tie sweep --------------------

@pytest.fixture(scope="module")
def jax_soak():
    return _jax_example("parity_soak")


@pytest.mark.parametrize("preset", parity_soak.PRESETS)
def test_parity_soak_preset_equals_jax_engine_and_port_oracle(preset,
                                                              jax_soak):
    assert parity_soak.PRESETS == jax_soak.PRESETS
    seed = parity_soak.soak_seed(preset, 0)
    got, oracle = parity_soak.match_fixture(preset, seed, "cpu")
    np.testing.assert_array_equal(got, oracle)

    # the JAX engine on the same fixture (the JAX soak's own staging)
    fx = _jax_helper("make_fixture")(np.random.RandomState(seed), n_seq=4,
                                     n_test=2, codebook=64)
    cfg = JaxMatchConfig(**{**JAX_PRESETS[preset].__dict__,
                            "codebook_size": 64})
    db = jax_stage_db(cfg, fx["bundle"], fx["codes"], fx["signature"],
                      wavlm=fx["wavlm"], wavvq=fx["wavvq"])
    ta = jax_stage_audio(cfg, db, test_bundle=fx["test_bundle"],
                         wavlm=fx["test_wavlm"], wavvq=fx["test_wavvq"]) \
        if cfg.use_aud else None
    tc = jax_stage_context(db, fx["test_context"]) if cfg.use_txt else None
    want = JaxEngine(cfg, db).predict(
        ta, tc, rng=np.random.RandomState(cfg.seed)).codes
    np.testing.assert_array_equal(got, want)


def test_parity_soak_and_sweep_run_clean_on_the_cpu():
    bad, rows = parity_soak.run(1, "cpu", log=lambda s: None)
    assert bad == 0 and len(rows) == len(parity_soak.PRESETS)
    # the sweep's overrides reach the engine's config: "high" with 16-bit
    # residency selects codes on the CPU too
    got, want = parity_soak.match_fixture("shipped", 5, "cpu",
                                          cosine_precision="high",
                                          feat_dtype="bfloat16")
    assert got.shape == want.shape == (2, 30)
    assert parity_soak.cli(["0", "--device", "cpu"]) == 0


def test_long_clip_equals_jax():
    bad, rows = chip_parity_sweep.run_long_clip("cpu", log=lambda s: None)
    got = rows[0]["codes"]
    assert bad == 0 and rows[0]["n_diff"] == 0 and got.shape == (2, 450)
    fx = _jax_helper("make_long_fixture")(np.random.RandomState(3600))
    cfg = JaxMatchConfig(**{**JAX_PRESETS["mfcc"].__dict__,
                            "codebook_size": 48, "num_frames": 3600,
                            "num_frames_code": 450})
    db = jax_stage_db(cfg, fx["bundle"], fx["codes"], fx["signature"])
    ta = jax_stage_audio(cfg, db, test_bundle=fx["test_bundle"])
    want = JaxEngine(cfg, db).predict(
        ta, None, rng=np.random.RandomState(cfg.seed)).codes
    np.testing.assert_array_equal(got, want)


def test_gesture_knn_equals_jax():
    from qpgesture_tpu.match.gesture_knn import GestureKNNData as JaxData
    from qpgesture_tpu.match.gesture_knn import \
        GestureKNNEngine as JaxKNN
    from qpgesture_tpu_torch.match.gesture_knn import (GestureKNNData,
                                                       GestureKNNEngine)
    bad, rows = chip_parity_sweep.run_gesture_knn(3, "cpu",
                                                  log=lambda s: None)
    assert bad == 0 and len(rows) == 3
    for i in range(3):
        rng = np.random.RandomState(31 + i)
        K, L, A, P, J = 5, 64, 12, 8, 15
        arrays = dict(feat=rng.randn(K, L, A + P).astype(np.float32),
                      motion=rng.randn(K, L, J).astype(np.float32),
                      control_mask=np.ones((K, L)), n_aud=A)
        feat_test = rng.randn(A, 64).astype(np.float32)
        got = GestureKNNEngine(GestureKNNData(**arrays), device="cpu"
                               ).search_motion(feat_test, 1, 10)
        want = np.asarray(JaxKNN(JaxData(**arrays)).search_motion(
            feat_test, init_seq=1, init_frm=10))
        np.testing.assert_allclose(got, want, rtol=0, atol=GESTURE_ATOL)


def test_tie_divergence_sweep_equals_jax():
    jax_tie = _jax_example("tie_divergence_sweep")
    got = tie_divergence_sweep.main(3, device="cpu", log=lambda s: None)
    assert got == jax_tie.main(3)


# ---- the scale study ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_scale():
    return _jax_example("scale_study")


@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["wavvq", "wavlm"])
def test_scale_study_bytes_equal_jax(mode, feat_dtype, jax_scale):
    """The staged database's bytes against the JAX example's
    _hbm_bytes(devdb) on the same J=32 data: the same tensors with the same
    elements; the feature tensors' bytes equal, and the port's index tables
    (codes, blocks, window starts) are int64 where JAX's are int32."""
    J = 32
    row = scale_study.run(mode, J, feat_dtype=feat_dtype, device="cpu")
    cfg, db, _, _, _ = scale_study.stage(mode, J, feat_dtype)
    devdb = port_bench.CodeKNNEngine(cfg, db, device="cpu").devdb

    rng = np.random.RandomState(0)
    common = jax_scale._build_common(rng, J)
    _, _, engine, _, _ = jax_scale._stage_mode(
        mode, rng, J, scale_study.W, *common, feat_dtype=feat_dtype)
    jdb = engine.devdb
    index_elems = 0
    for f in dataclasses.fields(jdb):
        a, b = getattr(jdb, f.name), getattr(devdb, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        assert a.size == b.numel(), f.name
        if f.name.endswith("_feat"):
            assert a.nbytes == b.numel() * b.element_size(), f.name
        else:
            assert (a.dtype.itemsize, b.element_size()) == (4, 8), f.name
            index_elems += b.numel()
    jax_bytes = jax_scale._hbm_bytes(jdb)
    assert row["db_hbm_bytes"] == scale_study.devdb_bytes(devdb)
    assert row["db_hbm_bytes"] == jax_bytes + 4 * index_elems
    assert row["host_draw_s"] >= 0 and "device_ms" not in row


def test_chunked_randn_equals_one_call():
    for shape, rows in (((37, 5, 3), 8), ((3, 199, 17), 256), ((5, 2), 1)):
        a = np.random.RandomState(11)
        b = np.random.RandomState(11)
        np.testing.assert_array_equal(
            port_bench.randn_f32(a, *shape, rows=rows),
            b.randn(*shape).astype(np.float32))
        np.testing.assert_array_equal(a.randn(4), b.randn(4))


# ---- streaming and serving ---------------------------------------------------

def _jax_database(mode, rng, J):
    """The JAX soak's database draws and staging at J."""
    from qpgesture_tpu.core import constants as C
    from qpgesture_tpu.core.schemas import CodebookSignature, DatabaseBundle
    bundle = DatabaseBundle(
        context=rng.randn(J, 30, C.CONTEXT_DIM).astype(np.float32),
        phase=rng.rand(J, C.NUM_FRAMES, 4, 8).astype(np.float32))
    codes = rng.randint(0, C.CODEBOOK_SIZE, size=(J, 30)).astype(np.int32)
    signature = CodebookSignature(
        code=np.tile(np.arange(C.CODEBOOK_SIZE)[:, None], (1, 30)),
        poses=np.zeros((C.CODEBOOK_SIZE, 1, 1), np.float32),
        signature=rng.randn(C.CODEBOOK_SIZE, C.POSE_DIM).astype(np.float32))
    if mode == "wavvq":
        cfg = JAX_PRESETS["wavvq"]

        def draw(r, n):
            return r.randint(0, C.WAVVQ_VOCAB, size=(n, C.WAVVQ_FRAMES, 2)
                             ).astype(np.int32)
        key = "wavvq"
    else:
        cfg = JAX_PRESETS["shipped"]

        def draw(r, n):
            return r.randn(n, C.WAVLM_FRAMES, 1024).astype(np.float32)
        key = "wavlm"
    db = jax_stage_db(cfg, bundle, codes, signature, **{key: draw(rng, J)})
    return cfg, db, lambda r, n: jax_stage_audio(cfg, db, **{key: draw(r, n)})


@pytest.mark.parametrize("mode", ["wavvq", "wavlm"])
def test_streaming_soak_equals_jax_sessions_and_pool(mode):
    from qpgesture_tpu.serve import StreamingPool, StreamingSession
    J, n = 16, 4
    row, got = streaming_soak.soak(mode, n, J=J, device="cpu")
    assert row["bit_equal_to_whole_clip"] and got.shape == (n, 30)
    rng = np.random.RandomState(0)
    cfg, db, audio = _jax_database(mode, rng, J)
    ta = audio(rng, n)
    tc = jax_stage_context(db, rng.randn(n, 30, 384).astype(np.float32))
    sess = StreamingSession(JaxEngine(cfg, db),
                            rng=np.random.RandomState(cfg.seed))
    want = np.stack([sess.push_window(ta[w], tc[w]) for w in range(n)])
    np.testing.assert_array_equal(got, want)

    C_, ticks = 3, 4
    row, got = streaming_soak.soak_pool(mode, ticks, n_streams=C_, J=J,
                                        device="cpu")
    assert row["streams_bit_equal_to_solo"] and got.shape == (ticks, C_, 30)
    cfg, db, audio = _jax_database(mode, np.random.RandomState(1), J)
    pool = StreamingPool(JaxEngine(cfg, db), C_,
                         rngs=[np.random.RandomState(cfg.seed + i)
                               for i in range(C_)])
    for w in range(ticks):
        ta = np.stack([audio(np.random.RandomState(1000 + 97 * i + w), 1)[0]
                       for i in range(C_)])
        tc = np.stack([jax_stage_context(db, np.random.RandomState(
            5000 + 97 * i + w).randn(1, 30, 384).astype(np.float32))[0]
            for i in range(C_)])
        np.testing.assert_array_equal(got[w], np.asarray(pool.tick(ta, tc)))


def test_serve_production_equals_jax():
    """The JAX script's four modes on its own draws, against the port's."""
    from qpgesture_tpu.core import constants as C
    from qpgesture_tpu.serve import StreamingPool
    got = serve_production.main("cpu", log=lambda s: None)

    rng = np.random.RandomState(0)
    cfg, J = JAX_PRESETS["wavvq"], 256
    from qpgesture_tpu.core.schemas import CodebookSignature, DatabaseBundle
    bundle = DatabaseBundle(
        context=rng.randn(J, 30, C.CONTEXT_DIM).astype(np.float32),
        phase=rng.rand(J, C.NUM_FRAMES, 4, 8).astype(np.float32))
    codes = rng.randint(0, C.CODEBOOK_SIZE, size=(J, 30)).astype(np.int32)
    signature = CodebookSignature(
        code=np.tile(np.arange(C.CODEBOOK_SIZE)[:, None], (1, 30)),
        poses=np.zeros((C.CODEBOOK_SIZE, 1, 1), np.float32),
        signature=rng.randn(C.CODEBOOK_SIZE, C.POSE_DIM).astype(np.float32))
    wavvq = rng.randint(0, C.WAVVQ_VOCAB,
                        size=(J, C.WAVVQ_FRAMES, 2)).astype(np.int32)
    db = jax_stage_db(cfg, bundle, codes, signature, wavvq=wavvq)
    engine = JaxEngine(cfg, db)

    def make_clip(n):
        tw = rng.randint(0, C.WAVVQ_VOCAB,
                         size=(n, C.WAVVQ_FRAMES, 2)).astype(np.int32)
        tc = rng.randn(n, 30, C.CONTEXT_DIM).astype(np.float32)
        return jax_stage_audio(cfg, db, wavvq=tw), jax_stage_context(db, tc)

    np.testing.assert_array_equal(got["single"],
                                  engine.predict(*make_clip(6)).codes)
    for w, codes_w in zip((3, 4), got["bucketed"]):
        np.testing.assert_array_equal(
            codes_w, engine.predict_bucketed(*make_clip(w)).codes)
    clips = [make_clip(2) for _ in range(4)]
    want = engine.predict_batch(np.stack([a for a, _ in clips]),
                                np.stack([c for _, c in clips]))
    for g, r in zip(got["batched"], want):
        np.testing.assert_array_equal(g, r.codes)
    pool = StreamingPool(engine, n_streams=8)
    for tick in range(3):
        ta = np.stack([make_clip(1)[0][0] for _ in range(8)])
        tc = np.stack([make_clip(1)[1][0] for _ in range(8)])
        np.testing.assert_array_equal(got["pool"][tick],
                                      np.asarray(pool.tick(ta, tc)))


# ---- the training campaign ---------------------------------------------------

def test_make_corpus_equals_jax():
    jax_camp = _jax_example("train_campaign")
    for seed, n, frames in ((20260817, 3, 500), (7, 2, 4096)):
        _assert_tree_equal(
            train_campaign.make_corpus(np.random.RandomState(seed), n,
                                       frames),
            jax_camp.make_corpus(np.random.RandomState(seed), n, frames),
            "corpus")


def test_campaign_kill_resume_and_post_eval(tmp_path):
    cfg = VQVAEConfig(width=16, depth=1, emb_width=16, l_bins=32)
    out = str(tmp_path / "campaign")
    base = ["--out", out, "--epochs", "4", "--eval-every", "2", "--clips",
            "4", "--clip-frames", "600", "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        train_campaign.main(base + ["--stop-after", "2"], model_cfg=cfg,
                            batch_size=8)
    assert e.value.code == train_campaign.KILL_EXIT
    assert sorted(os.listdir(out)) == ["002.pt", "best.pt",
                                       "campaign_report.json", "latest.pt",
                                       "scalars.jsonl"]
    report = train_campaign.main(base + ["--resume"], model_cfg=cfg,
                                 batch_size=8)
    spe = report["steps_per_epoch"]
    assert spe == 48 // 8
    assert report["total_steps"] == 4 * spe
    assert [r["epoch"] for r in report["epochs_run"]] == [1, 2, 3, 4]
    with open(os.path.join(out, "campaign_report.json")) as f:
        assert json.load(f)["epochs_run"] == report["epochs_run"]
    for name in ("best", "latest", "002", "004"):
        assert os.path.isfile(os.path.join(out, f"{name}.pt"))
    state = torch.load(os.path.join(out, "004.pt"), weights_only=True)
    assert state["step"] == 4 * spe and state["epoch"] == 4
    rows = train_campaign.main(base + ["--post-eval"], model_cfg=cfg)
    assert [r["checkpoint"] for r in rows] == ["002", "004", "best"]
    assert [r["step"] for r in rows[:2]] == [2 * spe, 4 * spe]
    for r in rows:
        assert all(np.isfinite(r[k]) and r[k] >= 0
                   for k in ("hellinger", "fgd", "fgd_feature"))


# ---- the demo and the raw-wav probe -----------------------------------------

def test_demo_host_stage_equals_jax_and_writes_a_bvh(tmp_path):
    from qpgesture_tpu.motion.bvh import parse_bvh as jax_parse_bvh
    from qpgesture_tpu.motion.pipeline import \
        MotionPipeline as JaxPipeline
    from qpgesture_tpu.pipelines.database_builder import (
        hashed_embed_fn, process_recording, window_recordings)
    from qpgesture_tpu_torch.motion.bvh import parse_bvh
    from qpgesture_tpu_torch.pipelines.database_builder import \
        window_recordings as port_window
    make_bvh = _jax_helper("make_beat_like_bvh")
    _, port_recs = demo_synthetic.make_recordings(np.random.RandomState(0),
                                                  seconds=3.0)
    rng = np.random.RandomState(0)
    pipeline, jax_recs = None, []
    for name in demo_synthetic.NAMES:
        bvh = jax_parse_bvh(make_bvh(rng, 3 * 120))
        pipeline = pipeline or JaxPipeline(fps=60).fit(bvh)
        n = 3 * 16000
        wav = (0.3 * np.sin(2 * np.pi * 170 * np.arange(n) / 16000)
               + 0.02 * rng.randn(n)).astype(np.float32)
        words = [(t, t + 0.25, f"word{int(t*2)}")
                 for t in np.arange(0.3, 2.0, 0.6)]
        jax_recs.append(process_recording(name, bvh, wav, pipeline, words))
    for p, j in zip(port_recs, jax_recs):
        for f in ("name", "rotation", "rotation_mirror", "wav", "mfcc",
                  "energy", "pitch", "volume", "words"):
            _assert_tree_equal(getattr(p, f), getattr(j, f), f)
    _assert_tree_equal(
        port_window(port_recs, 120, embed_fn=hashed_embed_fn()),
        window_recordings(jax_recs, 120, embed_fn=hashed_embed_fn()),
        "bundle")

    out = demo_synthetic.main(str(tmp_path / "demo"), "cpu",
                              log=lambda s: None)
    bvh = parse_bvh(out["bvh"])
    assert out["codes"].shape == (out["n_windows"], 30)
    assert bvh.values.shape[0] == out["n_windows"] * 240
    assert np.isfinite(bvh.values).all()


@pytest.mark.parametrize("mode,want", [
    ("wavvq", ("wavvq", False, "highest")),
    ("wavlm_split", ("wavlm", True, "highest")),
    ("wavlm:high", ("wavlm", False, "high")),
    ("wavlm_split:default", ("wavlm", True, "default")),
    ("wavvq:default", ValueError), ("wavlm:fast", ValueError),
    ("mfcc", ValueError)])
def test_rawwav_mode_parsing(mode, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            rawwav_latency.parse_mode(mode)
    else:
        assert rawwav_latency.parse_mode(mode) == want


def test_rawwav_wavvq_split_on_the_cpu(monkeypatch):
    """A wavvq_split request at J=16 on the CPU, with a narrow vq-wav2vec
    (the encoder's width does not change the path): the row holds the
    host-clock keys and no device time."""
    from qpgesture_tpu_torch.models.vq_wav2vec import (VQWav2Vec,
                                                       VQWav2VecConfig)
    small = VQWav2VecConfig(conv_layers=((32, 10, 5), (32, 8, 4),
                                         (32, 4, 2), (32, 4, 2),
                                         (32, 4, 2)))
    monkeypatch.setattr(port_bench, "_encoder", lambda base, precision,
                        device=None: VQWav2Vec(small, device=device))
    row = rawwav_latency.run("wavvq_split", "cpu", J=16)
    assert row["mode"] == "wavvq_split" and row["e2e_p50_ms"] > 0
    assert row["first_call_wall_s"] > 0 and row["gest_s_per_s"] > 0
    assert "device_ms" not in row   # the CPU has no device time

def test_examples_default_to_the_card(tmp_path):
    """Without device="cpu" every example asks for the card, which a
    machine without one refuses with the resolver's message."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    calls = [
        lambda: parity_soak.match_fixture("wavvq", 1),
        lambda: chip_parity_sweep.run_gesture_knn(1, log=lambda s: None),
        lambda: tie_divergence_sweep.main(1, log=lambda s: None),
        lambda: scale_study.run("wavvq", 8),
        lambda: streaming_soak.soak("wavvq", 4, J=8),
        lambda: serve_production.main(log=lambda s: None),
        lambda: rawwav_latency.run("wavvq", J=8),
        lambda: train_campaign.main(["--out", str(tmp_path / "c"),
                                     "--clips", "1", "--clip-frames",
                                     "300"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
