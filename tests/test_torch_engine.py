"""Matching engine: the port against the JAX engine on the same staged
fixtures — phase-1 raw triples and candidate tables, then predicted codes,
phases and votes across the 7-combination preset sweep."""
import dataclasses
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qpgesture_tpu.core.config import MATCH_PRESETS
from qpgesture_tpu.match import database as jax_db
from qpgesture_tpu.match import engine as jax_engine
from qpgesture_tpu_torch.match import database as port_db
from qpgesture_tpu_torch.match import engine as port_engine
from qpgesture_tpu_torch.ops.ranking import tree_sum

from fixtures import make_fixture
from test_torch_staging import port_config, stage

SWEEP = ["wavvq", "wavvq_aud_only", "shipped", "no_phase", "no_text",
         "no_audio", "mfcc"]
CPU = torch.device("cpu")


def _configs(preset, **extra):
    cfg = dataclasses.replace(MATCH_PRESETS[preset], codebook_size=64,
                              **extra)
    return cfg, port_config(cfg)


def _fixture(preset):
    # deterministic per-preset seed (hash() is randomized per process)
    rng = np.random.RandomState(2024 + zlib.crc32(preset.encode()) % 1000)
    return make_fixture(rng, n_seq=4, n_test=2, codebook=64)


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("preset,wavvq_mode", [
    ("wavvq", "combine"), ("wavvq", "sum"), ("shipped", "combine"),
    ("mfcc", "combine")])
def test_phase1_tables_match_jax(preset, wavvq_mode):
    """(mins, args, matched) and the rank/block/seq/start/pos tables.
    Integer (edit) distances are bit-equal. Cosine distances come from a
    float32 matmul whose summation order differs between XLA and PyTorch:
    they agree within 2.5e-7 (2 ulp at 1.0), and argmins, ranks and tables
    are equal."""
    fx = _fixture(preset)
    jcfg, pcfg = _configs(preset, wavvq_mode=wavvq_mode)
    jdb, ta, tc = stage(jax_db, jcfg, fx)
    pdb, _, _ = stage(port_db, pcfg, fx)
    jdev = jax_engine.device_match_db(jcfg, jdb)
    pdev = port_engine.device_match_db(pcfg, pdb, CPU)
    j_raw = jax_engine._raw_tables_impl(jcfg, jdev, _jnp(ta), _jnp(tc))
    p_raw = port_engine._raw_tables_impl(pcfg, pdev, _torch(ta), _torch(tc))
    for j_side, p_side in zip(j_raw, p_raw):
        if j_side is None:
            assert p_side is None
            continue
        (jm, ja, jmat), (pm, pa, pmat) = j_side, p_side
        if preset.startswith("wavvq") and j_side is j_raw[0]:
            np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        else:
            np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0,
                                       atol=2.5e-7)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(pmat.numpy(), np.asarray(jmat))

    jt = jax_engine._tables_impl(jcfg, jdev, _jnp(ta), _jnp(tc))
    pt = port_engine._tables_impl(pcfg, pdev, _torch(ta), _torch(tc))
    assert jt.n_steps == pt.n_steps
    for name in ("aud_rank", "aud_block", "aud_seq", "aud_start", "aud_pos",
                 "txt_rank", "txt_block", "txt_seq", "txt_start", "txt_pos"):
        j, p = getattr(jt, name), getattr(pt, name)
        if j is None:
            assert p is None, name
            continue
        np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=name)


@pytest.mark.parametrize("preset", SWEEP)
def test_predict_matches_jax(preset):
    """Codes bit-identical, phases within 1e-6, votes equal. no_phase runs
    with desired_k=2 (the k-th smallest selection); mfcc covers the
    non-chaining per-window reset path."""
    fx = _fixture(preset)
    extra = {"desired_k": 2} if preset == "no_phase" else {}
    jcfg, pcfg = _configs(preset, **extra)
    jdb, ta, tc = stage(jax_db, jcfg, fx)
    pdb, _, _ = stage(port_db, pcfg, fx)
    want = jax_engine.CodeKNNEngine(jcfg, jdb).predict(
        ta, tc, rng=np.random.RandomState(jcfg.seed))
    got = port_engine.CodeKNNEngine(pcfg, pdb, device="cpu").predict(
        ta, tc, rng=np.random.RandomState(pcfg.seed))
    assert got.codes.dtype == np.int32
    np.testing.assert_array_equal(got.codes, want.codes)
    if want.phases is None:
        assert got.phases is None
    else:
        np.testing.assert_allclose(got.phases, want.phases, rtol=0,
                                   atol=1e-6)
    if want.votes is None:
        assert got.votes is None
    else:
        np.testing.assert_array_equal(got.votes, want.votes)


def test_predict_with_explicit_seed_matches_jax():
    """An explicit init code/phase bypasses the oracle draw on both sides."""
    fx = _fixture("wavvq")
    jcfg, pcfg = _configs("wavvq")
    jdb, ta, tc = stage(jax_db, jcfg, fx)
    pdb, _, _ = stage(port_db, pcfg, fx)
    phase = np.random.RandomState(1).rand(8, 16).astype(np.float32)
    want = jax_engine.CodeKNNEngine(jcfg, jdb).predict(
        ta, tc, init_code=7, init_phase=phase)
    got = port_engine.CodeKNNEngine(pcfg, pdb, device="cpu").predict(
        ta, tc, init_code=7, init_phase=phase)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.votes, want.votes)


def test_tree_sum_is_a_fixed_order_sum():
    """The engine's fixed-order sum (ops/ranking.tree_sum), at a power of
    two as the phase-continuity distances take it and at odd lengths, over
    the last axis and a leading one."""
    x = torch.arange(128, dtype=torch.float32).reshape(1, 128) / 7
    assert tree_sum(x).shape == (1,)
    np.testing.assert_allclose(tree_sum(x).numpy(),
                               x.double().sum(-1).numpy(), rtol=1e-6)
    for n in (45, 180, 3):
        z = torch.arange(n * 2, dtype=torch.float32).reshape(n, 2) / 7
        np.testing.assert_allclose(tree_sum(z, 0).numpy(),
                                   z.double().sum(0).numpy(), rtol=1e-6)
