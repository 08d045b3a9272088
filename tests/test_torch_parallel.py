"""Database-sharded matching in real process groups: 2 and 3 gloo ranks on
the CPU (3 pads the J axis), each started by ``parallel.dist.spawn``. Every
sharded entry point (the tables, predict_sharded, predict_batch_sharded,
StreamingPool.tick_sharded interleaved with tick, RawWavServer.serve_sharded
and match --sharded) gives on every rank the codes, phases and votes (and
the carried seeds) of the JAX package's sharded path on make_mesh(n) and of
the port's single-process path, bit for bit (tests/test_parallel.py is the
model). The ranks run every case of one world size in one spawn
(tests/torch_dist_cases.py)."""
import concurrent.futures
import copy
import dataclasses
import zlib

import numpy as np
import pytest
import torch

from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu.core.config import MATCH_PRESETS, MatchConfig
from qpgesture_tpu.core.schemas import load_result
from qpgesture_tpu.match import database as jax_db
from qpgesture_tpu.match import engine as jax_engine
from qpgesture_tpu.parallel.mesh import make_mesh
from qpgesture_tpu.parallel.sharded_match import (build_sharded_tables,
                                                  sharded_min_reduce_demo)
from qpgesture_tpu.serve import StreamingPool as JaxPool
from qpgesture_tpu_torch.match import database as port_db
from qpgesture_tpu_torch.match.engine import CodeKNNEngine, should_shard
from qpgesture_tpu_torch.parallel.dist import spawn
from qpgesture_tpu_torch.serve import StreamingPool

import torch_dist_cases
from fixtures import make_fixture
from test_torch_batch import raw_servers
from test_torch_serve import _write_inputs
from test_torch_staging import port_config, stage

WORLDS = (2, 3)
INTERLEAVE = MatchConfig(audio_mode="feat", use_aud=True, use_txt=True,
                         use_phase=False, chain_windows=False)
# the tick schedule of the interleaved pool: sharded, plain, sharded
TICKS = (True, False, True)


def _case(cfg, seed, n_seq, n_test, codebook):
    """(JAX cfg, port cfg, fixture, JAX db, port db, test audio, context)."""
    rng = np.random.RandomState(seed)
    fx = make_fixture(rng, n_seq=n_seq, n_test=n_test, codebook=codebook)
    cfg = dataclasses.replace(cfg, codebook_size=codebook)
    jdb, ta, tc = stage(jax_db, cfg, fx)
    pdb, _, _ = stage(port_db, port_config(cfg), fx)
    return cfg, port_config(cfg), fx, jdb, pdb, ta, tc


def _engine(c):
    """A fresh port engine of a case: nothing staged on it yet."""
    return CodeKNNEngine(c[1], c[4], device="cpu")


TABLE_CASES = {
    "wavvq": (MATCH_PRESETS["wavvq"], 5, 6, 2, 64),
    "shipped": (MATCH_PRESETS["shipped"], 5, 6, 2, 64),
    "shipped f16": (dataclasses.replace(MATCH_PRESETS["shipped"],
                                        feat_dtype="float16"), 91, 6, 2, 64),
    "shipped bf16": (dataclasses.replace(MATCH_PRESETS["shipped"],
                                         feat_dtype="bfloat16"), 91, 6, 2,
                     64),
    "shipped_fast": (MATCH_PRESETS["shipped_fast"], 5, 6, 2, 64),
}
PREDICT_CASES = {
    "wavvq": (MATCH_PRESETS["wavvq"], 606, 6, 2, 48),
    "shipped": (MATCH_PRESETS["shipped"], 606, 6, 2, 48),
    "wavvq sum": (dataclasses.replace(MATCH_PRESETS["wavvq"],
                                      wavvq_mode="sum"), 909, 4, 1, 48),
    "mfcc": (MATCH_PRESETS["mfcc"], 717, 6, 3, 48),
    "mfcc_raw": (MATCH_PRESETS["mfcc_raw"], 717, 6, 3, 48),
    "interleave": (INTERLEAVE, 717, 6, 3, 48),
}
TICK_CASES = {p: (MATCH_PRESETS[p], 17, 6, 4, 64)
              for p in ("wavvq", "shipped")}
# held against the port's single-process path alone: the JAX package's
# sharded path is bit-equal to its predict (tests/test_parallel.py), which
# the port's predict equals (tests/test_torch_engine.py); its compiles
# would double this file's time
PORT_ONLY = {"shipped bf16", "mfcc_raw", "interleave", "shipped tick",
             "shipped serve"}


def _tick_windows(c):
    cfg, _, _, _, _, ta, tc = c

    def win(arr, w):
        if arr is None:
            return None
        return np.stack([arr[w % len(arr)], arr[(w + 1) % len(arr)]])

    return [(win(ta, w) if cfg.use_aud else None,
             win(tc, w) if cfg.use_txt else None) for w in range(len(TICKS))]


def _match_argv(tmp_path):
    rng = np.random.RandomState(8)
    fx = make_fixture(rng, n_seq=7, n_test=2, codebook=64)
    p = _write_inputs(tmp_path, fx, rng)
    return ["match", "--train-database", p["db"],
            "--train-codebook", p["codes"], "--codebook-signature", p["sig"],
            "--train-wavvq", p["wavvq"], "--test-wavvq", p["test_wavvq"],
            "--test-data", p["test_bundle"], "--preset", "wavvq"]


def _jobs(n, tmp):
    """(the cases, the jobs, the CLI's files) of a group of n ranks."""
    jobs = {"demo": ("demo", ())}
    cases = {}
    for name, spec in TABLE_CASES.items():
        c = cases["tables", name] = _case(*spec)
        jobs["tables", name] = ("tables", (_engine(c), c[5], c[6]))
    for name, spec in PREDICT_CASES.items():
        c = cases["predict", name] = _case(*spec)
        jobs["predict", name] = ("predict", (_engine(c), c[5], c[6],
                                             c[0].seed))
    c = cases["batch"] = _case(MATCH_PRESETS["wavvq"], 909, 8, 2, 32)
    clips = tuple(None if x is None else np.stack([x] * 3) for x in c[5:7])
    jobs["batch"] = ("batch", (_engine(c), *clips, c[0].seed))
    for name, spec in TICK_CASES.items():
        c = cases["tick", name] = _case(*spec)
        jobs["tick", name] = ("tick", (StreamingPool(_engine(c), 2),
                                       _tick_windows(c), TICKS))
    for preset in ("wavvq", "shipped"):
        rng, jserver, server, n_samples = raw_servers(
            preset, 61 + zlib.crc32(preset.encode()) % 10)
        wav = (rng.randn(2, n_samples) * 3000).astype(np.int16)
        ctx = rng.randn(2, 30, 1, 384).astype(np.float32)
        cases["serve", preset] = (jserver, server, wav, ctx)
        # a copy: spawn moves the ranks' tensors to shared memory, and the
        # JAX server's weights may alias the port modules' host buffers
        jobs["serve", preset] = ("serve", (copy.deepcopy(server), wav, ctx,
                                           3, 0))
    c = cases["should_shard"] = _case(MATCH_PRESETS["wavvq"], 5, 6, 2, 64)
    jobs["should_shard"] = ("should_shard", (c[1], c[4]))
    argv = _match_argv(tmp)
    for mode, hbm in (("always", None), ("auto", 1)):
        out = str(tmp / f"port_{mode}.npz")
        jobs["cli", mode] = ("cli", (argv + [
            "--sharded", mode, "--out", out, "--device", "cpu",
            "--dist-backend", "gloo"], hbm))
    return cases, jobs, (tmp, argv)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{n: (the cases, every rank's results, the CLI's files)}: the groups
    of every world size run at once, each in its own processes."""
    made = {n: _jobs(n, tmp_path_factory.mktemp(f"match{n}"))
            for n in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {n: pool.submit(spawn, torch_dist_cases.run, n, (jobs,))
                for n, (_, jobs, _) in made.items()}
        return {n: (made[n][0], runs[n].result(), made[n][2])
                for n in WORLDS}


@pytest.fixture(params=WORLDS, ids=lambda n: f"{n}ranks")
def world(request, groups):
    """(n, the cases, every rank's results, the CLI's files) for a group
    of n gloo ranks."""
    return (request.param,) + groups[request.param]


def _same(got, want, name):
    if want is None:
        assert got is None, name
    else:
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


def _same_result(got, want, name):
    for field, g, w in zip(("codes", "phases", "votes"), got,
                           (want.codes, want.phases, want.votes)):
        _same(g, w, f"{name}: {field}")


def test_sharded_min_reduce_demo(world):
    n, _, results, _ = world
    assert all(r["demo"] for r in results)
    sharded_min_reduce_demo(make_mesh(n))


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_sharded_tables_match_single_device_and_jax(world, case):
    """The combined tables on every rank == the port's single-device tables
    == the JAX package's sharded tables on make_mesh(n): wavvq strings
    through the engine's edit distances, cosine features at "highest" and
    under 16-bit residency. At "high" (shipped_fast) the port's bf16x3 is
    held to its own single-device tables only: XLA on the CPU runs "high"
    in float32 (tests/test_torch_match_precision.py)."""
    n, cases, results, _ = world
    cfg, pcfg, fx, jdb, pdb, ta, tc = cases["tables", case]
    single = CodeKNNEngine(pcfg, pdb, device="cpu").tables(
        torch.from_numpy(ta), torch.from_numpy(tc))
    jax_t = None if case in PORT_ONLY | {"shipped_fast"} else \
        build_sharded_tables(cfg, jdb, make_mesh(n), ta, tc)
    for r in results:
        got = r["tables", case]
        for name, value in got.items():
            _same(value, getattr(single, name) if getattr(single, name)
                  is None else getattr(single, name).numpy(), name)
            if jax_t is not None and getattr(jax_t, name) is not None:
                _same(value, getattr(jax_t, name), f"jax {name}")


@pytest.mark.parametrize("case", sorted(PREDICT_CASES))
def test_predict_sharded_matches_jax_and_predict(world, case):
    """Codes, phases and votes on every rank == JAX's predict_sharded on
    make_mesh(n) == the port's predict, across presets, the wavvq 'sum'
    layout and the non-chaining multi-window configs; the rank's engine
    never staged its single-device database."""
    n, cases, results, _ = world
    cfg, pcfg, fx, jdb, pdb, ta, tc = cases["predict", case]
    want = CodeKNNEngine(pcfg, pdb, device="cpu").predict(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    jwant = None if case in PORT_ONLY else \
        jax_engine.CodeKNNEngine(cfg, jdb).predict_sharded(
            make_mesh(n), ta, tc, rng=np.random.RandomState(cfg.seed))
    for r in results:
        *got, staged = r["predict", case]
        _same_result(got, want, case)
        if jwant is not None:
            _same_result(got, jwant, f"{case}: jax")
        assert not staged, "predict_sharded staged the whole database"


def test_predict_batch_sharded_matches_jax_and_predict_batch(world):
    n, cases, results, _ = world
    cfg, pcfg, fx, jdb, pdb, ta, tc = cases["batch"]
    clips = [np.stack([x] * 3) for x in (ta, tc)]
    want = CodeKNNEngine(pcfg, pdb, device="cpu").predict_batch(
        *clips, rng=np.random.RandomState(cfg.seed))
    jwant = jax_engine.CodeKNNEngine(cfg, jdb).predict_batch_sharded(
        make_mesh(n), *clips, rng=np.random.RandomState(cfg.seed))
    for r in results:
        assert len(r["batch"]) == 3
        for got, w, jw in zip(r["batch"], want, jwant):
            _same_result(got, w, "batch")
            _same(got[0], jw.codes, "jax codes")


@pytest.mark.parametrize("preset", sorted(TICK_CASES))
def test_tick_sharded_interleaves_with_tick(world, preset):
    """tick_sharded, tick, tick_sharded on one pool == three ticks of a
    single-process pool == JAX's pool ticked the same way on make_mesh(n),
    codes and carried seeds."""
    n, cases, results, _ = world
    c = cases["tick", preset]
    cfg, pcfg, fx, jdb, pdb = c[:5]
    windows = _tick_windows(c)
    pool = StreamingPool(CodeKNNEngine(pcfg, pdb, device="cpu"), 2)
    want = [pool.tick(ta, tc) for ta, tc in windows]
    if f"{preset} tick" in PORT_ONLY:
        jpool, jwant = pool, want
    else:
        jpool, mesh = JaxPool(jax_engine.CodeKNNEngine(cfg, jdb), 2), \
            make_mesh(n)
        jwant = [jpool.tick_sharded(mesh, ta, tc) if s else
                 jpool.tick(ta, tc) for (ta, tc), s in zip(windows, TICKS)]
    for r in results:
        codes, state = r["tick", preset]
        for t, (g, w, jw) in enumerate(zip(codes, want, jwant)):
            _same(g, w, f"tick {t}")
            _same(g, jw, f"jax tick {t}")
        for g, w, jw in zip(state, pool.state(), jpool.state()):
            _same(g, w.numpy(), "state")
            _same(g, jw, "jax state")


@pytest.mark.parametrize("preset", ["wavvq", "shipped"])
def test_serve_sharded_matches_serve_and_jax(world, preset):
    """RawWavServer.serve_sharded (the encoder on every rank, the database
    sharded, the scan and decode replicated) == serve() in one process ==
    JAX's serve_sharded on make_mesh(n); poses within JAX's 1e-4 decode
    tolerance (tests/test_torch_serve.py)."""
    n, cases, results, _ = world
    jserver, server, wav, ctx = cases["serve", preset]
    want = server.serve(wav, ctx, init_code=3, rng=np.random.RandomState(0))
    jwant = want if f"{preset} serve" in PORT_ONLY else \
        jserver.serve_sharded(make_mesh(n), wav, ctx, init_code=3,
                              rng=np.random.RandomState(0))
    for r in results:
        codes, poses = r["serve", preset]
        _same(codes, want[0], "codes")
        _same(poses, want[1], "poses")
        _same(codes, jwant[0], "jax codes")
        np.testing.assert_allclose(poses, jwant[1], rtol=0, atol=1e-4)


def test_should_shard_under_qpg_hbm_bytes(world, monkeypatch):
    """More than one rank and a budget below the database's bytes spill; a
    large budget does not; the CPU reports no capacity. One process is a
    world of one and never spills."""
    n, cases, results, _ = world
    for r in results:
        assert r["should_shard"] == {"tiny budget": True,
                                     "large budget": False,
                                     "no report": False}
    _, pcfg, _, _, pdb = cases["should_shard"][:5]
    monkeypatch.setenv("QPG_HBM_BYTES", "1")
    assert not should_shard(pcfg, pdb, device="cpu")


def test_match_cli_sharded_matches_jax(world, monkeypatch):
    """match --sharded always and --sharded auto (QPG_HBM_BYTES below the
    database's bytes) in every rank: both take the sharded path, and rank
    0's result.npz equals the JAX CLI's on its 8-device mesh."""
    n, _, results, (tmp, argv) = world
    for r in results:
        assert r["cli", "always"] == 1 and r["cli", "auto"] == 1
    monkeypatch.setenv("QPG_HBM_BYTES", "1")
    for mode in ("always", "auto"):
        jout = str(tmp / f"jax_{mode}.npz")
        jax_cli(argv + ["--sharded", mode, "--out", jout])
        np.testing.assert_array_equal(
            load_result(str(tmp / f"port_{mode}.npz")), load_result(jout))


def test_lazy_devdb_in_one_process():
    """The engine stages its single-device database on first use:
    predict_sharded outside any group (a world of one) stages only its
    shard, which is the whole database, and predict then stages devdb."""
    c = _case(MATCH_PRESETS["wavvq"], 606, 6, 2, 48)
    engine = _engine(c)
    assert engine._devdb is None
    got = engine.predict_sharded(None, c[5], c[6],
                                 rng=np.random.RandomState(c[0].seed))
    assert engine._devdb is None and engine._sharded is not None
    want = engine.predict(c[5], c[6], rng=np.random.RandomState(c[0].seed))
    assert engine._devdb is not None
    _same_result((got.codes, got.phases, got.votes), want, "world of one")
