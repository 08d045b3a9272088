"""The spans' reading of a traced window (benchmark/spans.py) on a
synthetic chrome trace with runtime calls, kernels and marks, and span
records of two units: the clock offset, ownership (with ``outside`` and
``unowned``), the idle split by ``<stage>/<span>``, the span table, the
four readers; and the probe's rehearsal on the CPU."""
import json

import pytest
import torch

from benchmark import devtrace, span_probe, spans, spec

OFF = 5e6                      # trace us minus host us at the start marks
LAG = (0.0, 3.0)               # each unit's start-mark call after its read
ISSUED = [["start", "enc_start", "enc_end", "end"]] * 2


def _trace_and_records():
    """Two units 1000 us apart. Host us of unit 0 (unit 1: + 1000): spans
    serve [1010, 1900] > encode [1020, 1200], stage [1200, 1300], tables
    [1300, 1500], scan [1500, 1800]; launches (-> device us) encode 1050
    (1060-1150), stage 1250 (1255-1260), tables 1350 (1400-1450), scan
    1600 (1610-1620) and 1700 (1750-1760); a copy with no launch call
    (1160-1170); in unit 0 a launch after the unit, outside every span,
    1950 (1950-1960). Marks at 1001, 1021, 1201, 1901."""
    events, records = [], []
    corr = [100]

    def op(cat, name, t0, t1, launch=None, **args):
        corr[0] += 1
        c = corr[0]
        events.append({"ph": "X", "cat": cat, "name": name, "ts": t0 + OFF,
                       "dur": t1 - t0, "args": dict(args, correlation=c)})
        if launch is not None:
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "ts": launch + OFF,
                           "dur": 2.0, "args": {"correlation": c}})

    k = 0
    for u in range(2):
        b = 1000.0 * u
        for p, t in zip(ISSUED[u], (1001, 1021, 1201, 1901)):
            op("gpu_memcpy", "Memcpy DtoD", b + t, b + t + 0.5,
               launch=b + 1000 + LAG[u] if p == "start" else None,
               bytes=devtrace.mark_bytes(k))
            k += 1
        op("kernel", "enc", b + 1060, b + 1150, launch=b + 1050)
        op("gpu_memcpy", "Memcpy HtoD", b + 1160, b + 1170)
        op("kernel", "stage", b + 1255, b + 1260, launch=b + 1250)
        op("kernel", "lev_kernel", b + 1400, b + 1450, launch=b + 1350)
        op("kernel", "gather", b + 1610, b + 1620, launch=b + 1600)
        op("kernel", "where", b + 1750, b + 1760, launch=b + 1700)
        if u == 0:
            op("kernel", "after", 1950, 1960, launch=1950)
        root = len(records) + 100 * u
        ns = lambda t: int((b + t) * 1000)
        records.append({"name": "serve", "id": root, "parent": None,
                        "unit": root, "t0_ns": ns(1010), "t1_ns": ns(1900),
                        "counters": {"lanes": 1, "windows": 6}})
        for i, (name, t0, t1) in enumerate((
                ("encode", 1020, 1200), ("stage", 1200, 1300),
                ("tables", 1300, 1500), ("scan", 1500, 1800))):
            records.append({"name": name, "id": root + 1 + i,
                            "parent": root, "unit": root, "t0_ns": ns(t0),
                            "t1_ns": ns(t1),
                            "counters": {"steps": 48, "lanes": 1}
                            if name == "scan" else {}})
    host_ns = [1000 * 1000, 2000 * 1000]
    return {"traceEvents": events}, records, host_ns


@pytest.fixture
def reading():
    trace, records, host_ns = _trace_and_records()
    kernels, marks, lost = devtrace.parse(trace, ISSUED)
    assert lost == 0 and len(kernels) == 13
    window = (marks[0]["start"], marks[-1]["end"])
    return spans.attribute(trace, ISSUED, host_ns, records, marks, window,
                           2), trace, kernels, marks, window


def test_clock_offset_from_the_start_marks(reading):
    r = reading[0]
    assert r["clock"]["offset_s"] == pytest.approx((OFF + 1.5) * 1e-6)
    assert r["clock"]["spread_us"] == pytest.approx(3.0)
    assert r["clock"]["deviations_us"] == [-1.5, 1.5]


def test_ownership_outside_and_unowned(reading):
    rows = reading[0]["spans"]
    got = {n: (rows[n]["ops"], round(rows[n]["device_ms"] * 1e3, 6))
           for n in rows}
    # per unit: ops, device us
    assert got == {"encode": (1.0, 90.0), "stage": (1.0, 5.0),
                   "tables": (1.0, 50.0), "scan": (2.0, 20.0),
                   "serve": (0.0, 0.0), "outside": (0.5, 5.0)}
    ops = {op: (sec, by) for op, sec, by in reading[0]["device_ops"]}
    assert ops["enc"] == (pytest.approx(180e-6), {"encode": pytest.approx(
        180e-6)})
    assert ops["after"][1] == {"outside": pytest.approx(10e-6)}
    assert "Memcpy HtoD" not in ops                  # unowned
    assert reading[0]["unowned_s"] == pytest.approx(20e-6)
    assert reading[0]["outside_s"] == pytest.approx(10e-6)


def test_idle_split_by_stage_and_span(reading):
    r, _, kernels, _, (lo, hi) = reading
    gaps = dict(r["idle_gaps"])
    us = lambda name: round(gaps.get(name, 0.0) * 1e6, 6)
    # unit 0's scan (1501.5-1801.5 on the trace) over the gaps 1450-1610
    # and 1620-1750 (stage match) and 1760-1950 (ended after the end
    # mark: stage client); unit 1 the same
    assert us("match/scan") == 2 * (108.5 + 130.0)
    assert us("client/scan") == 2 * 41.5
    # from the window's start (1001), and from unit 0's last operation
    # (1960), to each serve span (1011.5, 2011.5)
    assert us("encoder/outside") == 10.5 + 51.5
    # to the encode kernel, and from it to the copy with no launch call
    assert us("encoder/encode") == 2 * (38.5 + 10.0)
    assert r["spans"]["scan"]["idle_ms"] * 1e3 == pytest.approx(280.0)
    # every idle second is named once: the names sum to the idle time
    busy = devtrace.TraceContext(
        cell="", config={}, traffic={}, device_name="", peaks=None,
        units=2, window=(lo, hi), kernels=kernels).busy_s()
    assert sum(gaps.values()) == pytest.approx(hi - lo - busy)
    assert all("/" in n for n in gaps)


def test_span_table_host_times_and_counters(reading):
    rows = reading[0]["spans"]
    # self time: 890 us less its children's 780
    assert rows["serve"]["host_ms"] == pytest.approx(0.11)
    assert rows["scan"]["host_ms"] == pytest.approx(0.3)
    assert rows["scan"]["counters"] == {"steps": 48.0, "lanes": 1.0}
    assert rows["serve"]["counters"] == {"lanes": 1.0, "windows": 6.0}


def test_readers(reading):
    r, _, kernels, marks, window = reading
    _, records, _ = _trace_and_records()
    ctx = devtrace.TraceContext(cell="", config={}, traffic={},
                                device_name="", peaks=None, units=2,
                                window=window, kernels=kernels, marks=marks)
    read = lambda m: spec.reader(m)(ctx)
    for m in ("stage_ms.clip", "tables_ms.tick", "scan_ms.batch",
              "scan_launches.clip"):
        assert read(m) is None                  # no spans recorded
    spans.attach(ctx, r, records, 2)
    assert read("stage_ms.clip") == pytest.approx(0.005)
    assert read("tables_ms.tick") == pytest.approx(0.05)
    assert read("scan_launches.batch") == 2.0
    assert read("scan_ms.clip") == pytest.approx(0.3)


def test_no_start_mark_call_reads_nothing():
    trace, records, host_ns = _trace_and_records()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e["cat"] != "cuda_runtime"]
    _, marks, _ = devtrace.parse(trace, ISSUED)
    assert spans.attribute(trace, ISSUED, host_ns, records, marks,
                           (0.0, 10.0), 2) is None


@pytest.mark.parametrize("cell", ["wavlm-large-j1024.clip",
                                  "vq-wav2vec-j16384.batch16",
                                  "wavlm-large-j1024.pool16"])
def test_probe_rehearsal_lists_the_span_metrics(capsys, cell):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = span_probe.main(["--workload", cell, "--seed",
                              str(2 ** 31 + 7), "--rehearse"])
    finally:
        torch.set_num_threads(prev)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    entry = spec.load_cell(cell).entry
    assert rc == 0 and out["metrics"] == {
        f"{m}.{entry.LATENCY}": "not measured"
        for m in ("stage_ms", "tables_ms", "scan_ms", "scan_launches")}
    per_unit = 6 if entry.LATENCY == "tick" else 7
    assert out["window"]["records"] == out["window"]["span_records"] \
        == per_unit * out["window"]["units"]
