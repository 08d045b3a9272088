"""The program's spans on the traced window's device timeline.

The port records a span at each layer boundary of its serving path
(``qpgesture_tpu_torch/utils/profiling.py``: name, id, parent, unit,
``perf_counter_ns`` at open and close, counters). This module puts them on
the trace's clock and reads the device timeline by them:

  * clock: the host reads ``perf_counter_ns`` right before it issues each
    unit's start mark; in the trace, the runtime call that queued that mark
    carries the mark copy's ``correlation`` and a ``ts`` on the trace's
    clock. The median of the per-unit differences is the offset; the
    kernels and the runtime calls share CUPTI's clock, so that one offset
    puts every span on the device timeline;
  * ownership: a device operation (marks excluded) belongs to the
    innermost span open on the host when its launch call began, matched by
    ``correlation``: ``outside`` when no span was open, ``unowned`` when
    the trace holds no launch call for it;
  * idle: each idle gap of the device splits among the innermost spans
    open on the host over it, by overlap, and is named
    ``<stage>/<span>``, the stage as ``devtrace.breakdown`` names it.

``attribute`` also gives the costliest device operations by name with the
seconds each span launched of them. ``attach`` sets ``ctx.spans`` (per
span name, each value per unit: host self ms, device ms owned, device
operations launched, idle ms, counters)
and ``ctx.span_window`` (per span name, host ms per unit of a window run
with spans on and no profiler), which the readers of ``METRICS`` take.
"""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from . import devtrace, yardstick

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside"
# the per-layer metrics that read the spans, each with the suffix of the
# cell's entry (LATENCY: clip, tick, batch)
METRICS = (("stage_ms", "ms"), ("tables_ms", "ms"), ("scan_ms", "ms"),
           ("scan_launches", "ops"))


def launches(trace: dict) -> Dict[int, float]:
    """correlation -> the launch call's start, seconds on the trace's
    clock."""
    out = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                out[c] = e["ts"] * 1e-6
    return out


def device_ops(trace: dict, n_marks: int):
    """(ops, marks): the device operations other than marks as (start s,
    end s, correlation or None, name), and each mark's correlation by its
    index."""
    ops, marks = [], {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in devtrace.DEVICE_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        k = devtrace._mark_index(e, n_marks)
        if k is not None:
            marks[k] = corr
            continue
        t0 = e["ts"] * 1e-6
        ops.append((t0, t0 + e["dur"] * 1e-6, corr, e["name"]))
    return ops, marks


def clock_offset(issued: List[List[str]], host_ns: Sequence[int],
                 mark_corr: Dict[int, int], launch: Dict[int, float]
                 ) -> Optional[dict]:
    """Trace seconds minus host seconds at each unit's start mark, from
    the call that queued it: the median (``offset_s``), the spread (max -
    min, ``spread_us``) and each unit's deviation from the median in us;
    None when no start mark's call is in the trace."""
    k, diffs = 0, []
    for u, points in enumerate(issued):
        for p in points:
            if p == "start" and u < len(host_ns):
                t = launch.get(mark_corr.get(k))
                if t is not None:
                    diffs.append(t - host_ns[u] * 1e-9)
            k += 1
    if not diffs:
        return None
    mid = statistics.median(diffs)
    return {"offset_s": mid, "spread_us": (max(diffs) - min(diffs)) * 1e6,
            "deviations_us": [round((d - mid) * 1e6, 1) for d in diffs]}


class Timeline:
    """The innermost span open at each host instant, from records whose
    spans nest (one stack), as segments on the trace's clock."""

    def __init__(self, records: List[dict], offset: float):
        self.edges: List[float] = []
        self.owners: List[str] = []
        stack: List[Tuple[float, str]] = []

        def close_until(t):
            while stack and stack[-1][0] <= t:
                end = stack.pop()[0]
                self.edges.append(end)
                self.owners.append(stack[-1][1] if stack else OUTSIDE)

        for r in sorted(records, key=lambda r: r["t0_ns"]):
            t0 = r["t0_ns"] * 1e-9 + offset
            close_until(t0)
            self.edges.append(t0)
            self.owners.append(r["name"])
            stack.append((r["t1_ns"] * 1e-9 + offset, r["name"]))
        close_until(float("inf"))

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.edges, t) - 1
        return self.owners[i] if i >= 0 else OUTSIDE

    def split(self, s: float, e: float) -> Dict[str, float]:
        """Seconds of [s, e) under each innermost span."""
        out: Dict[str, float] = defaultdict(float)
        i = bisect.bisect_right(self.edges, s) - 1
        t = s
        while t < e:
            nxt = self.edges[i + 1] if i + 1 < len(self.edges) else e
            end = min(nxt, e)
            out[self.owners[i] if i >= 0 else OUTSIDE] += end - t
            t, i = end, i + 1
        return out


def host_ms(records: List[dict], units: int, self_time: bool = True
            ) -> Dict[str, float]:
    """Host ms per unit of each span name: its duration, less its
    children's (self time) unless ``self_time`` is False."""
    child: Dict[int, int] = defaultdict(int)
    if self_time:
        for r in records:
            if r["parent"] is not None:
                child[r["parent"]] += r["t1_ns"] - r["t0_ns"]
    out: Dict[str, float] = defaultdict(float)
    for r in records:
        out[r["name"]] += (r["t1_ns"] - r["t0_ns"] - child[r["id"]]) * 1e-6
    return {k: v / units for k, v in out.items()}


def attribute(trace: dict, issued: List[List[str]], host_ns: Sequence[int],
              records: List[dict], marks: List[Dict[str, float]],
              window: Tuple[float, float], units: int,
              top: Optional[int] = 10) -> Optional[dict]:
    """The spans' reading of the traced window (None when the trace holds
    no launch call of a start mark): ``spans`` per name, ``unowned_s``,
    ``outside_s``, the ``top`` idle gaps by ``<stage>/<span>`` and device
    operations by name with their seconds per span (all when None), and
    the clock."""
    n_marks = sum(len(p) for p in issued)
    ops, mark_corr = device_ops(trace, n_marks)
    launch = launches(trace)
    clock = clock_offset(issued, host_ns, mark_corr, launch)
    if clock is None:
        return None
    lo, hi = window
    line = Timeline(records, clock["offset_s"])
    owned: Dict[str, list] = defaultdict(list)
    unowned = []
    for s, e, corr, name in ops:
        if not lo <= s < hi:
            continue
        t = launch.get(corr)
        if t is None:
            unowned.append((s, e))
        else:
            owned[line.at(t)].append((s, e, name))

    stage_at = sorted((t, devtrace.STAGE_AFTER[p]) for unit in marks
                      for p, t in unit.items())
    gaps = yardstick.idle_gaps([op[:2] for op in ops], lo, hi)
    idle_by: Dict[str, float] = defaultdict(float)
    idle_span: Dict[str, float] = defaultdict(float)
    j, stage = 0, "client"
    for s, e in gaps:
        while j < len(stage_at) and stage_at[j][0] <= e:
            stage = stage_at[j][1]
            j += 1
        for name, sec in line.split(s, e).items():
            idle_by[f"{stage}/{name}"] += sec
            idle_span[name] += sec

    host = host_ms(records, units)
    counters: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    for r in records:
        for k, v in r["counters"].items():
            counters[r["name"]][k] += v / units
    union = lambda iv: yardstick.union_seconds((x[:2] for x in iv), lo, hi)
    spans = {}
    for name in sorted(set(host) | set(owned) | set(idle_span)):
        mine = owned.get(name, [])
        spans[name] = {
            "host_ms": host.get(name, 0.0),
            "device_ms": 1e3 * union(mine) / units,
            "ops": len(mine) / units,
            "idle_ms": 1e3 * idle_span.get(name, 0.0) / units,
            "counters": dict(counters.get(name, {}))}
    by_op: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    for span_name, mine in owned.items():
        for s, e, op in mine:
            by_op[op][span_name] += e - s
    rank = lambda d: sorted(d.items(), key=lambda x: -x[1])[:top]
    return {"spans": spans, "unowned_s": union(unowned),
            "outside_s": union(owned.get(OUTSIDE, [])),
            "idle_gaps": [[n, v] for n, v in rank(idle_by)],
            "device_ops": [[op, sum(d.values()), dict(d)] for op, d in sorted(
                by_op.items(), key=lambda x: -sum(x[1].values()))[:top]],
            "clock": clock}


def attach(ctx, reading: Optional[dict], window_records: List[dict],
           window_units: int) -> None:
    """Give a TraceContext what the span metrics read: ``ctx.spans`` (the
    traced window's span table) and ``ctx.span_window`` (host ms per unit
    inside each span, in the window of spans alone)."""
    ctx.spans = reading["spans"] if reading else None
    ctx.span_window = host_ms(window_records, window_units,
                              self_time=False) if window_units else None
