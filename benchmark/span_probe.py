"""One cell's traced window read by the program's spans, and a window of
spans alone; prints one JSON line.

    python3 benchmark/span_probe.py --workload <cell> --seed <n> [--rehearse]

As ``harness.py`` with ``--trace 1`` (set-up, warm-up, ``trace_units``
units under ``torch.profiler`` with the stage marks), with the program's
spans recorded (``utils/profiling.recording``) and the host's
``perf_counter_ns`` read before each unit's start mark. Before that
window, with no profiler or marks, the span window: 2 x ``trace_units``
units, spans off, on, on, off in turn (CUPTI left in the process after a
profiled window would slow it). Not checked against the reference. The
line holds the span metrics (``spans.METRICS``) and, to hold them
against, the cell's accepted per-layer metrics; ``breakdown``
(``spans``, ``unowned_s``, ``outside_s``, ``idle_gaps`` by
``<stage>/<span>``, ``device_ops`` with the seconds each span launched);
under ``window`` the clock offset's median, spread
and per-unit deviations, and the span window's median unit times with
spans on and off (``span_unit_s_median``, ``plain_unit_s_median``); and
the clock checks.
``--rehearse`` runs on the CPU at the configuration's rehearsal sizes and
measures nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import data as bdata  # noqa: E402
from benchmark import devtrace, harness, spans, spec  # noqa: E402
from benchmark import system, yardstick  # noqa: E402


def _checks(ctx, reading, metrics, latency) -> dict:
    """The clock checks: offset spread, unowned share of device time,
    encode's device time against encoder_ms, and stage + tables + scan
    (device and idle) against match_ms."""
    rows = reading["spans"]
    busy = ctx.busy_s()
    out = {"clock_spread_us": reading["clock"]["spread_us"],
           "unowned_share": reading["unowned_s"] / busy if busy else None}
    enc = metrics.get(f"encoder_ms.{latency}")
    if enc and "encode" in rows:
        out["encode_over_encoder_ms"] = rows["encode"]["device_ms"] / enc
    match = metrics.get(f"match_ms.{latency}")
    if match:
        part = sum(rows[n]["device_ms"] + rows[n]["idle_ms"]
                   for n in ("stage", "tables", "scan") if n in rows)
        out["match_spans_over_match_ms"] = part / match
    return out


def span_cost_us(profiling, n: int = 20000) -> dict:
    """Host us of one span with a counter set, under a recorder and with
    none."""
    def loop():
        t = time.perf_counter()
        for _ in range(n):
            with profiling.span("scan"):
                profiling.count("steps", 1)
        return (time.perf_counter() - t) / n * 1e6
    with profiling.recording():
        on = loop()
    return {"on": on, "off": loop()}


def run(args) -> int:
    from qpgesture_tpu_torch.utils import profiling
    cell = spec.load_cell(args.workload, root=spec.ROOT,
                          rehearse=args.rehearse)
    cuda = not args.rehearse
    if cuda and not torch.cuda.is_available():
        print(f"{cell.name} needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    cfg, traffic, seed, entry = cell.config, cell.traffic, args.seed, \
        cell.entry
    db = bdata.database(cfg, cell.model, seed, device)
    prog = system.Program(cfg, cell.model, entry, traffic, seed, device, db)
    enc_hooks = system.Hooks(prog.encoder)
    dec_hooks = system.Hooks(prog.decoder)

    def unit(i):
        return bdata.unit(traffic, entry, cfg, seed, i)

    for i in range(traffic["warmup_units"]):
        prog.run(unit(-1 - i))
    n = traffic["trace_units"]
    unit_s = {True: [], False: []}
    rec = profiling.Profiler()
    for i in range(n, 3 * n):         # off on on off: in the batch cell
        u, on = unit(i), i % 4 in (1, 2)  # every other unit ran ~4 % slower
        with profiling.recording(rec) if on else contextlib.nullcontext():
            t = time.perf_counter()
            prog.run(u)
            unit_s[on].append(time.perf_counter() - t)
    window_records = rec.take()
    units = [unit(i) for i in range(n)]
    marks = prof = None
    if cuda:
        marks = harness.Marks(enc_hooks, dec_hooks, 6 * n, device)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        torch.cuda.synchronize()
        # an unnamed copy (below a mark's bytes) after the wait, as the
        # previous unit's end mark comes before every later start mark: the
        # first start mark's call came 40-100 us late without it
        marks.dst[:1].copy_(marks.src[:1])
    host_ns = []
    with profiling.recording(rec):
        for u in units:
            if marks:
                host_ns.append(time.perf_counter_ns())
                marks.start()
            prog.run(u)
            if marks:
                marks.mark("end")
    records = rec.take()
    if cuda:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)

    names = [(f"{base}.{entry.LATENCY}", u) for base, u in spans.METRICS]
    out = {"cell": cell.name, "attempted": 3 * n, "checked": False}
    if not cuda:
        out["metrics"] = {m: "not measured" for m, _ in names}
        out["window"] = {"units": n, "span_units": len(unit_s[True]),
                         "records": len(records),
                         "span_records": len(window_records)}
        print(json.dumps(out))
        return 0
    trace = devtrace.read_chrome_trace(prof)
    kernels, unit_marks, lost = devtrace.parse(trace, marks.units)
    times = [t for m in unit_marks for t in m.values()]
    name = torch.cuda.get_device_name(device)
    ctx = devtrace.TraceContext(
        cell=cell.name, config=cfg, traffic=traffic, device_name=name,
        peaks=yardstick.peaks(name), units=n,
        window=(unit_marks[0].get("start", min(times)),
                unit_marks[-1].get("end", max(times))),
        kernels=kernels, marks=unit_marks, model=cell.model, entry=entry)
    reading = spans.attribute(trace, marks.units, host_ns, records,
                              unit_marks, ctx.window, n, top=None)
    spans.attach(ctx, reading, window_records, len(unit_s[True]))
    metrics = {}
    for m, unit_name in names + [(p["name"], p["unit"])
                                 for p in cell.per_layer]:
        read = spec.reader(m, root=spec.ROOT)
        v = read(ctx) if read is not None else None
        if v is not None:
            metrics[m] = {"value": v, "unit": unit_name}
    flat = {k: v["value"] for k, v in metrics.items()}
    out.update(
        metrics=metrics,
        device={"kind": name, "power_limit": harness.power_limit(),
                "busy_s": ctx.busy_s(), "window_s": ctx.window_s},
        breakdown={k: reading[k] for k in ("spans", "unowned_s", "outside_s",
                                           "idle_gaps", "device_ops")}
        if reading else None,
        window={"units": n, "marks_lost": lost,
                "clock": reading and reading["clock"],
                "span_unit_s_median": statistics.median(unit_s[True]),
                "plain_unit_s_median": statistics.median(unit_s[False]),
                "span_cost_us": span_cost_us(profiling),
                "spans_per_unit": len(records) / n},
        checks=_checks(ctx, reading, flat, entry.LATENCY) if reading
        else None)
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rehearse", action="store_true")
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
