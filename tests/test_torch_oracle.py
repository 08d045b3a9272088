"""The NumPy oracle and reference-ties matching: the port's CodeKNNOracle
against the JAX package's for the preset sweep under both tie kinds, the
engine's predict_reference_ties (phase 1 on the device, the fusion in the
reference's arithmetic on the host) against JAX's, and match --ties
reference through both CLIs.

NumPy's default (unstable) sort may order ties differently on another CPU,
so every comparison runs both packages in this process."""
import dataclasses
import zlib

import numpy as np
import pytest

from qpgesture_tpu.cli import main as jax_cli
from qpgesture_tpu.core.config import MATCH_PRESETS
from qpgesture_tpu.core.schemas import load_result
from qpgesture_tpu.match import database as jax_db
from qpgesture_tpu.match.engine import CodeKNNEngine as JaxEngine
from qpgesture_tpu.match.oracle import CodeKNNOracle as JaxOracle
from qpgesture_tpu_torch.cli import main as port_cli
from qpgesture_tpu_torch.match import database as port_db
from qpgesture_tpu_torch.match import oracle as port_oracle
from qpgesture_tpu_torch.match.engine import CodeKNNEngine as PortEngine

from fixtures import make_fixture
from test_torch_serve import _write_inputs
from test_torch_staging import port_config, stage

SWEEP = ["wavvq", "wavvq_aud_only", "shipped", "no_phase", "no_text",
         "no_audio", "mfcc"]


def _staged(preset, seed_base=4100, n_seq=3, **extra):
    rng = np.random.RandomState(seed_base
                                + zlib.crc32(preset.encode()) % 1000)
    fx = make_fixture(rng, n_seq=n_seq, n_test=2, codebook=64)
    cfg = dataclasses.replace(MATCH_PRESETS[preset], codebook_size=64,
                              **extra)
    pcfg = port_config(cfg)
    jdb, ta, tc = stage(jax_db, cfg, fx)
    pdb, _, _ = stage(port_db, pcfg, fx)
    return cfg, pcfg, jdb, pdb, ta, tc


def _assert_result_equal(got, want):
    np.testing.assert_array_equal(got.codes, want.codes)
    for name in ("phases", "votes"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("tie_kind", ["stable", "reference"])
@pytest.mark.parametrize("preset", SWEEP)
def test_oracle_matches_jax(preset, tie_kind):
    extra = {"desired_k": 2} if preset == "no_phase" else {}
    cfg, pcfg, jdb, pdb, ta, tc = _staged(preset, **extra)
    want = JaxOracle(jdb, tie_kind=tie_kind).predict(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    got = port_oracle.CodeKNNOracle(pdb, tie_kind=tie_kind).predict(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    _assert_result_equal(got, want)


def test_oracle_pieces_match_jax():
    """The per-step candidate tables and the phase helpers, element for
    element."""
    from qpgesture_tpu.match import oracle as jo
    cfg, pcfg, jdb, pdb, ta, tc = _staged("wavvq")
    for fn, q in ((jo.audio_candidates, ta[0, 1]),
                  (jo.text_candidates, tc[1, 0])):
        want = fn(jdb, q)
        got = getattr(port_oracle, fn.__name__)(pdb, q)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    head, tail = port_oracle.phase_window(pdb, 1, 37)
    jhead, jtail = jo.phase_window(jdb, 1, 37)
    np.testing.assert_array_equal(head, jhead)
    np.testing.assert_array_equal(tail, jtail)
    assert port_oracle.phase_continuity(tail, head) == \
        jo.phase_continuity(jtail, jhead)


@pytest.mark.parametrize("preset", ["wavvq", "shipped"])
def test_predict_reference_ties_matches_jax(preset):
    """Phase 1's distances (integer edit distances for wavvq, float32
    cosines for shipped) go through the same reference-ties fusion: codes,
    phases and votes equal JAX's, and, for wavvq, the full reference-ties
    oracle's."""
    cfg, pcfg, jdb, pdb, ta, tc = _staged(preset, seed_base=4300)
    want = JaxEngine(cfg, jdb).predict_reference_ties(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    got = PortEngine(pcfg, pdb, device="cpu").predict_reference_ties(
        ta, tc, rng=np.random.RandomState(cfg.seed))
    _assert_result_equal(got, want)
    if preset == "wavvq":
        full = port_oracle.CodeKNNOracle(pdb, tie_kind="reference").predict(
            ta, tc, rng=np.random.RandomState(cfg.seed))
        _assert_result_equal(got, full)


def test_match_cli_reference_ties_matches_jax(tmp_path):
    rng = np.random.RandomState(12)
    fx = make_fixture(rng, n_seq=4, n_test=2, codebook=64)
    p = _write_inputs(tmp_path, fx, rng)
    args = ["match", "--train-database", p["db"],
            "--train-codebook", p["codes"], "--codebook-signature", p["sig"],
            "--train-wavvq", p["wavvq"], "--test-wavvq", p["test_wavvq"],
            "--test-data", p["test_bundle"], "--preset", "wavvq",
            "--ties", "reference"]
    jax_cli(args + ["--out", str(tmp_path / "jax.npz")])
    port_cli(args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    np.testing.assert_array_equal(load_result(str(tmp_path / "port.npz")),
                                  load_result(str(tmp_path / "jax.npz")))
