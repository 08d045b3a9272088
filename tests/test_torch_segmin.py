"""Kernel K7's semantics on the CPU (ops/segmin_cuda.py): the plain
per-code reduction against a NumPy loop of the reference's strict-<
update (GestureKNN.py:686-689) on ties, negative distances and both zeros,
codes that never occur, ragged N and several query counts; the non-finite
cases the kernel keeps; int32 distances reduced as float32; the wrapper's
refusals; the plan of the kernel's grid; the engine handing the reduction
K1's int32 matrix; and no launch or counter on the CPU. The kernel itself
is held to the plain version on the card (tests/test_torch_cuda.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from qpgesture_tpu_torch.core.config import MATCH_PRESETS
from qpgesture_tpu_torch.match import engine as eng
from qpgesture_tpu_torch.match.database import (stage_database,
                                                stage_test_audio,
                                                stage_test_context)
from qpgesture_tpu_torch.ops import segmin_cuda
from qpgesture_tpu_torch.utils import profiling

from fixtures import make_fixture

UNMATCHED = 1000.0


def strict_less_loop(dist: np.ndarray, seg: np.ndarray, k: int):
    """The reference's scan: a position replaces a code's candidate only if
    its distance is strictly less, so the first of equal distances stays."""
    Q, N = dist.shape
    best = np.full((Q, k), np.inf, np.float32)
    arg = np.zeros((Q, k), np.int64)
    seen = np.zeros((Q, k), bool)
    for n in range(N):
        c = seg[n]
        take = ~seen[:, c] | (dist[:, n] < best[:, c])
        best[take, c] = dist[take, n]
        arg[take, c] = n
        seen[:, c] = True
    return np.where(seen, best, np.float32(UNMATCHED)), arg, seen


def _case(name: str, rng: np.random.RandomState):
    """(dist (Q, N), seg (N,), k) of one adversarial case."""
    if name == "ties":              # few distinct values: every code ties
        Q, N, k = 5, 301, 16
        dist = rng.randint(0, 3, (Q, N)).astype(np.float32)
        seg = rng.randint(0, k, N)
    elif name == "negative and zeros":     # 1 - sim below 0; -0.0 / +0.0
        Q, N, k = 6, 257, 8
        dist = rng.choice(np.array([-0.0, 0.0, -1e-7, -2e-7, 1e-7, 0.5],
                                   np.float32), (Q, N))
        seg = rng.randint(0, k, N)
    elif name == "codes missing":   # codes 3 and 7 (and above 12) never occur
        Q, N, k = 4, 200, 16
        dist = rng.randn(Q, N).astype(np.float32)
        seg = rng.choice(np.array([0, 1, 2, 4, 5, 6, 8, 9, 10, 11, 12]), N)
    elif name == "k512 ragged N":   # N a multiple of no tile, nor of 4
        Q, N, k = 3, 3 * 2048 + 13, 512
        dist = rng.randint(0, 23, (Q, N)).astype(np.float32)
        seg = rng.randint(0, k, N)
    elif name.startswith("Q="):     # the engine's row counts at small N
        Q, N, k = int(name[2:]), 97, 512
        dist = (1.0 - rng.rand(Q, N)).astype(np.float32)
        seg = rng.randint(0, k, N)
    elif name == "int32":           # K1's edit distances as they come
        Q, N, k = 8, 1024 + 6, 64
        dist = rng.randint(0, 23, (Q, N)).astype(np.int32)
        seg = rng.randint(0, k, N)
    else:
        raise ValueError(name)
    return dist, seg.astype(np.int64), k


CASES = ["ties", "negative and zeros", "codes missing", "k512 ragged N",
         "Q=1", "Q=48", "Q=768", "int32"]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_the_strict_less_scan(name):
    dist, seg, k = _case(name, np.random.RandomState(CASES.index(name)))
    mins, args, matched = segmin_cuda.segment_min_argmin(
        torch.from_numpy(dist), torch.from_numpy(seg), k, UNMATCHED)
    want_m, want_a, want_ok = strict_less_loop(dist.astype(np.float32), seg,
                                               k)
    assert mins.dtype == torch.float32 and args.dtype == torch.int64
    np.testing.assert_array_equal(matched.numpy(), want_ok)
    np.testing.assert_array_equal(args.numpy(), want_a)
    # bit for bit: a -0.0 found first stays -0.0
    np.testing.assert_array_equal(mins.numpy().view(np.int32),
                                  want_m.view(np.int32))


def test_the_cases_hold_what_they_name():
    rng = np.random.RandomState(CASES.index("negative and zeros"))
    dist, _, _ = _case("negative and zeros", rng)
    assert (dist < 0).any() and (np.signbit(dist) & (dist == 0)).any()
    _, seg, k = _case("codes missing",
                      np.random.RandomState(CASES.index("codes missing")))
    assert not np.isin([3, 7, 13, 15], seg).any()
    _, seg, _ = _case("k512 ragged N", np.random.RandomState(0))
    assert seg.shape[0] % 4 and seg.shape[0] % 2048


def test_non_finite_distances():
    """What K7 keeps beyond the reference's domain: a code whose least
    distance is +-inf is unmatched at its first such position; a NaN
    among a code's distances leaves it unmatched at position 0."""
    inf, nan = float("inf"), float("nan")
    dist = torch.tensor([[1.0, inf, inf, -inf, 2.0, nan, 0.5, inf]])
    seg = torch.tensor([0, 1, 1, 2, 2, 3, 3, 5])
    mins, args, matched = segmin_cuda.segment_min_argmin(dist, seg, 6,
                                                         UNMATCHED)
    assert mins.tolist() == [[1.0] + [UNMATCHED] * 5]
    assert args.tolist() == [[0, 1, 3, 0, 0, 7]]
    assert matched.tolist() == [[True] + [False] * 5]


def test_int32_is_reduced_as_its_float32_copy():
    dist, seg, k = _case("int32", np.random.RandomState(3))
    d, s = torch.from_numpy(dist), torch.from_numpy(seg)
    got = segmin_cuda.segment_min_argmin(d, s, k, UNMATCHED)
    want = segmin_cuda.segment_min_argmin(d.to(torch.float32), s, k,
                                          UNMATCHED)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("case", ["float64", "int64 dist", "int32 seg",
                                  "1-D dist", "seg length",
                                  "dist not contiguous", "seg not contiguous",
                                  "device", "k"])
def test_wrapper_refuses_misuse(case):
    dist = torch.rand(4, 10)
    seg = torch.randint(0, 8, (10,))
    k, err = 8, ValueError
    if case == "float64":
        dist, err = dist.double(), TypeError
    elif case == "int64 dist":
        dist, err = dist.long(), TypeError
    elif case == "int32 seg":
        seg, err = seg.int(), TypeError
    elif case == "1-D dist":
        dist = dist[0]
    elif case == "seg length":
        seg = seg[:9]
    elif case == "dist not contiguous":
        dist = torch.rand(10, 4).T
    elif case == "seg not contiguous":
        seg = torch.randint(0, 8, (20,))[::2]
    elif case == "device":
        dist, seg = dist.to("meta"), seg.to("meta")
    else:
        k = 0
    with pytest.raises(err):
        segmin_cuda.segment_min_argmin(dist, seg, k, UNMATCHED)


def test_imports_and_runs_without_nvcc_or_a_card():
    """The CPU path loads no library and counts no launch."""
    before = segmin_cuda.launches
    segmin_cuda.segment_min_argmin(torch.rand(2, 5),
                                   torch.tensor([0, 1, 0, 1, 1]), 2,
                                   UNMATCHED)
    assert segmin_cuda.launches == before and segmin_cuda._lib is None
    assert segmin_cuda.SOURCE == "segmin.cu"


@pytest.mark.parametrize("Q,N,per_sm,splits", [
    (768, 425984, 4, 5), (48, 425984, 4, 88), (768, 425984, 7, 9),
    (48, 26624, 4, 13), (128, 26624, 4, 13), (8, 26624 * 16, 4, 208),
    (4096, 425984, 4, 1), (1, 10, 4, 1), (5, 2048 * 3 + 13, 4, 3)])
def test_plan_fills_one_wave(Q, N, per_sm, splits):
    """The vq-wav2vec batch's 768 and clip's 48 queries against 425 984
    positions, J=1024's clip and tick, a lone stream, more row groups than
    the card holds, and ragged N on a 132-SM card: chunks of a multiple of
    4 columns, none empty, the last reaching N, at least MIN_COLS each
    where N allows, and at most one wave of blocks where the rows allow."""
    got, chunk = segmin_cuda.plan(Q, N, 132, per_sm)
    assert got == splits and chunk % 4 == 0
    assert (got - 1) * chunk < N <= got * chunk
    assert chunk >= min(N, segmin_cuda.MIN_COLS)
    groups = -(-Q // segmin_cuda.ROWS)
    assert groups * got <= max(132 * per_sm, groups)


def _wavvq_engine(mode: str):
    rng = np.random.RandomState(21)
    fx = make_fixture(rng, n_seq=4, n_test=2, codebook=64)
    cfg = dataclasses.replace(MATCH_PRESETS["wavvq"], codebook_size=64,
                              wavvq_mode=mode)
    db = stage_database(cfg, fx["bundle"], fx["codes"], fx["signature"],
                        wavvq=fx["wavvq"])
    ta = stage_test_audio(cfg, db, wavvq=fx["test_wavvq"])
    tc = stage_test_context(db, fx["test_context"])
    return eng.CodeKNNEngine(cfg, db, device="cpu"), ta, tc


@pytest.mark.parametrize("mode", ["combine", "sum"])
def test_edit_distances_reach_the_reduction_as_int32(monkeypatch, mode):
    """The audio side hands K1's int32 matrix to the reduction, which then
    gives what its float32 copy gives."""
    engine, ta, tc = _wavvq_engine(mode)
    cfg, devdb = engine.cfg, engine.devdb
    q = torch.as_tensor(ta.reshape(ta.shape[0] * ta.shape[1],
                                   *ta.shape[2:]))
    seen = []
    real = eng.segment_min_argmin
    monkeypatch.setattr(eng, "segment_min_argmin",
                        lambda d, *a: seen.append(d.dtype) or real(d, *a))
    got = eng._minargs_one_side(cfg, q, devdb.aud_feat, devdb.aud_codes,
                                True)
    assert seen == [torch.int32]
    want = segmin_cuda.segment_min_argmin_plain(
        eng.string_distance_matrix(q, devdb.aud_feat).float(),
        devdb.aud_codes.reshape(-1), cfg.codebook_size, cfg.unmatched_dist)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_no_kernel_or_counter_on_the_cpu():
    engine, ta, tc = _wavvq_engine("combine")
    before = segmin_cuda.launches
    with profiling.recording() as prof:
        engine.predict(ta, tc)
    assert segmin_cuda.launches == before
    for rec in prof.take():
        assert "segmin_kernel" not in rec["counters"]
