"""Cosine tables below "highest" and low-precision residency: the port's
"high" (bf16x3, the shipped_fast preset) and "default" tables, and its
bfloat16 / float16 feature databases, against the JAX package's engine and
oracle on the same staged fixtures, against float64 evaluations of the
same rounded products, and through the match CLI."""
import dataclasses
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu.core.config import MATCH_PRESETS
from qpgesture_tpu.core.schemas import load_result, save_codes, save_wavlm
from qpgesture_tpu.match import database as jax_db
from qpgesture_tpu.match import engine as jax_engine
from qpgesture_tpu.match.oracle import CodeKNNOracle as JaxOracle
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.match import database as port_db
from qpgesture_tpu_torch.match import engine as port_engine

from fixtures import make_fixture
from test_torch_staging import port_config, stage

CPU = torch.device("cpu")
# the port's bf16x3 / bf16 products against a float64 evaluation of the
# same rounded operands: float32 sums of 32-6144 terms of unit-norm rows
PRODUCT_ATOL = 1e-5


def _configs(**extra):
    cfg = dataclasses.replace(MATCH_PRESETS["shipped"], codebook_size=64,
                              **extra)
    return cfg, port_config(cfg)


def _precision_fixture(precision):
    # tests/test_match_parity.py::test_cosine_precision_variants_match_oracle
    rng = np.random.RandomState(77 + zlib.crc32(precision.encode()) % 100)
    return make_fixture(rng, n_seq=4, n_test=2, codebook=64)


@pytest.mark.parametrize("preset,precision", [
    ("shipped", "highest"), ("shipped_fast", "high"),
    ("shipped", "default")])
def test_codes_match_jax_engine_and_oracle(preset, precision):
    """Codes equal the JAX engine's and the JAX oracle's. JAX's CPU computes
    HIGH and DEFAULT in float32, the port rounds the operands as the card
    does, so parity here is on codes, not on distance bits."""
    fx = _precision_fixture("highest" if precision == "highest"
                            else precision)
    cfg = dataclasses.replace(MATCH_PRESETS[preset], codebook_size=64,
                              cosine_precision=precision)
    pcfg = port_config(cfg)
    jdb, ta, tc = stage(jax_db, cfg, fx)
    pdb, _, _ = stage(port_db, pcfg, fx)
    want = jax_engine.CodeKNNEngine(cfg, jdb).predict(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    oracle = JaxOracle(jdb).predict(ta, tc,
                                    rng=np.random.RandomState(cfg.seed))
    got = port_engine.CodeKNNEngine(pcfg, pdb, device="cpu").predict(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    np.testing.assert_array_equal(want.codes, oracle.codes)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.votes, want.votes)


def _unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("precision,D", [("high", 32), ("high", 6144),
                                         ("default", 6144)])
def test_cosine_products_match_float64(precision, D):
    """The staged split and the query's split, multiplied in float64 in
    matmul_bf16x3's three products (or the one bf16 product), against the
    port's distances."""
    from qpgesture_tpu_torch.ops.precision import split_bf16
    rng = np.random.RandomState(D)
    q = torch.from_numpy(rng.randn(12, D).astype(np.float32))
    flat = rng.randn(300, D).astype(np.float32)
    _, pcfg = _configs(cosine_precision=precision)
    dn = port_engine._stage_aud_feat(pcfg, flat, CPU)
    got = port_engine.cosine_distance_prenorm(q, dn).numpy()
    q_hi, q_lo = (t.double() for t in split_bf16(port_engine._l2_normalize(q)))
    if precision == "high":
        d_hi, d_lo = (t.double() for t in dn)
        sim = q_hi @ d_hi.T + (q_hi @ d_lo.T + q_lo @ d_hi.T)
        # the split is of the float32-normalized rows
        want_rows = torch.from_numpy(flat)
        want_rows = want_rows / want_rows.norm(dim=1, keepdim=True)
        assert float((d_hi + d_lo - want_rows.double()).abs().max()) < 2e-5
    else:
        assert dn.dtype == torch.bfloat16
        sim = q_hi @ dn.double().T
    np.testing.assert_allclose(got, 1.0 - sim.numpy(), rtol=0,
                               atol=PRODUCT_ATOL)


def _residency_rows(rng):
    """Database rows holding tiny components too: in a normalized
    6144-wide row some fall below float16's normal range (6.1e-5)."""
    flat = rng.randn(40, 6144).astype(np.float32)
    flat[::3] *= np.float32(1e-3) ** rng.rand(6144).astype(np.float32)
    flat[1, :7] = [0.0, 1e-30, -1e-9, 3e-8, 6e-5, -6.2e-5, 1e-45]
    flat[5] = 0.0                                   # a zero row stays zero
    return flat


@pytest.mark.parametrize("feat_dtype,view", [("bfloat16", np.uint16),
                                             ("float16", np.uint16)])
def test_residency_staging_bits_match_jax(feat_dtype, view):
    rng = np.random.RandomState(31)
    flat = _residency_rows(rng)
    want = np.asarray(jax_engine.stage_cosine_features(flat, feat_dtype))
    got = port_engine.stage_cosine_features(flat, feat_dtype)
    assert str(got.dtype).endswith(feat_dtype)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(view),
                                  want.view(view))
    assert (np.abs(want.astype(np.float32)) < 6.1e-5).any()


@pytest.mark.parametrize("feat_dtype", ["bfloat16", "float16"])
def test_residency_tables_and_codes_match_jax(feat_dtype):
    """Tables' ranks (and the rest of the tables) equal JAX's low-precision
    tables, codes equal JAX's engine; the resident database is the staged
    16-bit tensor, half of float32's bytes."""
    fx = _precision_fixture(feat_dtype)
    cfg, pcfg = _configs(feat_dtype=feat_dtype)
    jdb, ta, tc = stage(jax_db, cfg, fx)
    pdb, _, _ = stage(port_db, pcfg, fx)
    jdev = jax_engine.device_match_db(cfg, jdb)
    pdev = port_engine.device_match_db(pcfg, pdb, CPU)
    assert str(pdev.aud_feat.dtype).endswith(feat_dtype)
    np.testing.assert_array_equal(
        pdev.aud_feat.view(torch.int16).numpy(),
        np.asarray(jdev.aud_feat).view(np.int16))
    assert port_engine.estimate_devdb_bytes(pcfg, pdb) == \
        jax_engine.estimate_devdb_bytes(cfg, jdb)
    jt = jax_engine._tables_impl(cfg, jdev, jnp.asarray(ta), jnp.asarray(tc))
    pt = port_engine._tables_impl(pcfg, pdev, torch.from_numpy(ta),
                                  torch.from_numpy(tc))
    for name in ("aud_rank", "aud_block", "aud_seq", "aud_start", "aud_pos"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    want = jax_engine.CodeKNNEngine(cfg, jdb).predict(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    got = port_engine.CodeKNNEngine(pcfg, pdb, device="cpu").predict(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    np.testing.assert_array_equal(got.codes, want.codes)


@pytest.mark.parametrize("feat_dtype", ["bfloat16", "float16"])
def test_wavvq_ignores_feat_dtype(feat_dtype):
    """wavvq strings are int32: feat_dtype leaves the staged database and
    the codes bit-identical (JAX's test_feat_dtype_wavvq_mode_unaffected)."""
    rng = np.random.RandomState(5)
    fx = make_fixture(rng, n_seq=4, n_test=2, codebook=64)
    base = dataclasses.replace(MATCH_PRESETS["wavvq"], codebook_size=64)
    results = []
    for cfg in (base, dataclasses.replace(base, feat_dtype=feat_dtype)):
        pcfg = port_config(cfg)
        pdb, ta, tc = stage(port_db, pcfg, fx)
        engine = port_engine.CodeKNNEngine(pcfg, pdb, device="cpu")
        assert engine.devdb.aud_feat.dtype == torch.int32
        results.append(engine.predict(
            ta, tc, rng=np.random.RandomState(cfg.seed)).codes)
    np.testing.assert_array_equal(results[0], results[1])


def test_shipped_fast_batch_lanes_equal_solo_predict():
    fx = _precision_fixture("high")
    cfg = dataclasses.replace(MATCH_PRESETS["shipped_fast"], codebook_size=64)
    pcfg = port_config(cfg)
    pdb, ta, tc = stage(port_db, pcfg, fx)
    engine = port_engine.CodeKNNEngine(pcfg, pdb, device="cpu")
    clips_a = np.stack([ta, ta[::-1]])
    clips_c = np.stack([tc, tc[::-1]])
    init = np.array([3, 17], np.int32)
    phases = np.random.RandomState(2).rand(2, 8, 16).astype(np.float32)
    lanes = engine.predict_batch(clips_a, clips_c, init_codes=init,
                                 init_phases=phases)
    for c in range(2):
        solo = engine.predict(clips_a[c], clips_c[c], init_code=int(init[c]),
                              init_phase=phases[c])
        np.testing.assert_array_equal(lanes[c].codes, solo.codes)
        np.testing.assert_array_equal(lanes[c].votes, solo.votes)
        np.testing.assert_array_equal(lanes[c].phases, solo.phases)


def test_match_cli_shipped_fast_float16_matches_jax(tmp_path):
    rng = np.random.RandomState(8)
    fx = make_fixture(rng, n_seq=4, n_test=2, codebook=64)
    p = {k: str(tmp_path / f"{k}.npz") for k in
         ("db", "codes", "sig", "wavlm", "test_wavlm", "test")}
    fx["bundle"].save(p["db"])
    save_codes(p["codes"], fx["codes"])
    fx["signature"].save(p["sig"])
    save_wavlm(p["wavlm"], fx["wavlm"])
    save_wavlm(p["test_wavlm"], fx["test_wavlm"])
    dataclasses.replace(fx["bundle"], context=rng.randn(
        2, 30, 1, 384).astype(np.float32)).save(p["test"])
    args = ["match", "--train-database", p["db"],
            "--train-codebook", p["codes"], "--codebook-signature", p["sig"],
            "--train-wavlm", p["wavlm"], "--test-wavlm", p["test_wavlm"],
            "--test-data", p["test"], "--preset", "shipped_fast",
            "--feat-dtype", "float16"]
    jax_cli(args + ["--out", str(tmp_path / "jax.npz")])
    port_cli(args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    np.testing.assert_array_equal(load_result(str(tmp_path / "port.npz")),
                                  load_result(str(tmp_path / "jax.npz")))
