"""The serving path's spans (utils/profiling.span under recording()): none
without a recorder, the same codes and poses with one, and for one serve,
one serve_batch and one StreamingRawWavPool.tick exactly the spans of the
serving path, one unit each, nested in time, with their counters. Also the
interval union that device_busy takes."""
import dataclasses

import numpy as np
import pytest
import torch

from qpgesture_tpu_torch.core.config import MATCH_PRESETS
from qpgesture_tpu_torch.match import database as port_db
from qpgesture_tpu_torch.match.engine import CodeKNNEngine
from qpgesture_tpu_torch.models import wavlm as pw
from qpgesture_tpu_torch.serve import RawWavServer, StreamingRawWavPool
from qpgesture_tpu_torch.utils import profiling

from fixtures import make_fixture
from test_torch_rawwav import WAVLM_SMALL, _port_vqw2v
from test_torch_serve import _port_vqvae
from test_torch_staging import stage

CHILDREN = {"serve": ["encode", "stage", "tables", "scan", "decode", "fetch"],
            "serve_batch": ["encode", "stage", "tables", "scan", "decode",
                            "fetch"],
            "tick": ["encode", "stage", "tables", "scan", "fetch"]}


def _server(preset):
    """A port RawWavServer on the CPU over a 4-sequence fixture database:
    a 2-layer WavLM (shipped) or a small vq-wav2vec (wavvq); and the
    samples of one window."""
    rng = np.random.RandomState(71)
    fx = make_fixture(rng, n_seq=4, n_test=2, codebook=32)
    cfg = dataclasses.replace(MATCH_PRESETS[preset], codebook_size=32)
    db, _, _ = stage(port_db, cfg, fx)
    if preset == "shipped":
        torch.manual_seed(3)
        encoder, n = pw.WavLM(pw.WavLMConfig(**WAVLM_SMALL), device="cpu"), \
            2000
    else:
        encoder, n = _port_vqw2v(), 64000
    mean = rng.randn(135).astype(np.float32)
    std = rng.rand(135).astype(np.float32) + 0.5
    return RawWavServer(CodeKNNEngine(cfg, db, device="cpu"), _port_vqvae(),
                        encoder, mean, std), n


def _requests(server, n, entry):
    """(call, lanes C, windows W): one request of the entry on seeded
    int16 windows and context; ``call`` gives (codes, poses or None) and
    may be called again with the same result (the pool is built anew)."""
    rng = np.random.RandomState(5)
    C, W = {"serve": (1, 2), "serve_batch": (2, 2), "tick": (3, 1)}[entry]
    wav = (rng.randn(C, W, n) * 2000).astype(np.int16)
    ctx = rng.randn(C, W, 30, 384).astype(np.float32)
    if entry == "serve":
        return (lambda: server.serve(wav[0], ctx[0], init_code=5)), C, W
    if entry == "serve_batch":
        return (lambda: server.serve_batch(
            wav, ctx, init_codes=np.array([3, 9], np.int32))), C, W

    def tick():
        pool = StreamingRawWavPool(server, C, init_codes=[1, 2, 3])
        return pool.tick(wav[:, 0], ctx[:, 0]), None
    return tick, C, W


@pytest.fixture(scope="module")
def shipped():
    return _server("shipped")


def test_no_recorder_no_spans(shipped):
    """Without a recorder every span is the one shared no-op context, a
    counter goes nowhere, and a Profiler that is not active records
    nothing of a serve."""
    assert profiling.span("scan") is profiling.span("tables") \
        is profiling._NOOP
    profiling.count("steps", 3)
    prof = profiling.Profiler()
    call, _, _ = _requests(*shipped, "serve")
    call()
    assert prof.take() == [] and prof.report() == {}


@pytest.mark.parametrize("preset", ["shipped", "wavvq"])
@pytest.mark.parametrize("entry", sorted(CHILDREN))
def test_recording_changes_no_result(preset, entry, shipped):
    server, n = shipped if preset == "shipped" else _server(preset)
    call, _, _ = _requests(server, n, entry)
    off = call()
    with profiling.recording() as prof:
        on = call()
    assert prof.take()
    for a, b in zip(off, on):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.mark.parametrize("entry", sorted(CHILDREN))
def test_each_entry_records_the_serving_spans(entry, shipped):
    server, n = shipped
    call, C, W = _requests(server, n, entry)
    with profiling.recording() as prof:
        call()
        first = prof.take()
        call()
        second = prof.take()
    assert prof.take() == []
    units = set()
    for recs in (first, second):
        root = recs[0]
        assert [r["name"] for r in recs] == [entry] + CHILDREN[entry]
        assert root["parent"] is None and root["unit"] == root["id"]
        assert root["counters"] == {"lanes": C, "windows": W}
        units.add(root["unit"])
        for r in recs:
            assert r["unit"] == root["unit"]
            assert r["t0_ns"] <= r["t1_ns"]
        for r in recs[1:]:
            assert r["parent"] == root["id"]
            assert root["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= root["t1_ns"]
        for a, b in zip(recs[1:], recs[2:]):      # children in turn
            assert a["t1_ns"] <= b["t0_ns"]
        scan = next(r for r in recs if r["name"] == "scan")
        assert scan["counters"] == {"steps": W * server.n_steps, "lanes": C}
        assert all(r["counters"] == {} for r in recs[1:] if r is not scan)
    assert len(units) == 2
    # the spans are the Profiler's phases too
    assert prof.report()[f"{entry}/scan"]["count"] == 2


def test_recording_nests_and_closes_a_failed_span():
    """recording() gives back the recorder that was active before it; a
    span whose body raises is closed and recorded; a root after it opens a
    new unit."""
    outer = profiling.Profiler()
    with profiling.recording(outer):
        with profiling.recording() as inner:
            with pytest.raises(RuntimeError):
                with profiling.span("serve"):
                    with profiling.span("scan"):
                        raise RuntimeError("boom")
            with profiling.span("tick"):
                pass
        assert profiling._ACTIVE is outer
        with profiling.span("serve"):
            pass
    assert profiling._ACTIVE is None
    recs = inner.take()
    assert [(r["name"], r["parent"], r["unit"]) for r in recs] == [
        ("serve", None, 0), ("scan", 0, 0), ("tick", None, 2)]
    assert all(r["t1_ns"] >= r["t0_ns"] > 0 for r in recs)
    assert [r["name"] for r in outer.take()] == ["serve"]


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 1.0), (2.0, 3.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),              # overlap counts once
    ([(1.0, 3.0), (0.0, 4.0), (2.0, 2.5)], 4.0),  # nested, out of order
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),              # touching
])
def test_union_length(intervals, want):
    assert profiling.union_length(intervals) == want
