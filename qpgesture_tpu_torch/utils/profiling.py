"""Profiling & tracing: phase-scoped wall timers with a structured JSON
report, the serving path's spans, the device's busy time under
``torch.profiler``, and a synchronizing timer. The port of the JAX
package's ``utils/profiling.py``.

Spans: program code opens ``with span("tables"):`` at a layer boundary and
sets a counter of the innermost open span with ``count("steps", n)``.
Nothing is recorded unless a block runs under ``recording()``; outside one
``span`` hands back one shared no-op context (a global read, no allocation,
no clock read) and ``count`` returns at once. Under ``recording()`` every
span is also a phase of the active ``Profiler`` and appends one record to
it (``Profiler.take``). A span opened with no span around it is a root: it
takes a fresh unit id, which its descendants share.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple


@dataclass
class Profiler:
    """Nested phase timers: with prof.phase('match'): ... While it is the
    active recorder (``recording``), each phase also appends a record:
    name, id, parent (the enclosing span's id, None for a root), unit (the
    root's id), t0_ns / t1_ns (``time.perf_counter_ns``) and counters."""
    totals: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    _stack: list = field(default_factory=list)
    _records: List[dict] = field(default_factory=list)
    _open: List[dict] = field(default_factory=list)
    _next_id: int = 0

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        label = "/".join(self._stack + [name])
        self._stack.append(name)
        rec = None
        if _ACTIVE is self:
            parent = self._open[-1] if self._open else None
            rec = {"name": name, "id": self._next_id,
                   "parent": parent["id"] if parent else None,
                   "unit": parent["unit"] if parent else self._next_id,
                   "t0_ns": 0, "t1_ns": 0, "counters": {}}
            self._next_id += 1
            self._records.append(rec)
            self._open.append(rec)
        start = time.perf_counter_ns()
        if rec is not None:
            rec["t0_ns"] = start
        try:
            yield
        finally:
            end = time.perf_counter_ns()
            self._stack.pop()
            self.totals[label] += (end - start) * 1e-9
            self.counts[label] += 1
            if rec is not None:
                rec["t1_ns"] = end
                self._open.pop()

    def count(self, key: str, n: int) -> None:
        """Set counter ``key`` of the innermost open recorded span."""
        if self._open:
            self._open[-1]["counters"][key] = n

    def take(self) -> List[dict]:
        """The records appended since the last take, in the order their
        spans opened."""
        out, self._records = self._records, []
        return out

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(self.totals[k], 4),
                    "count": self.counts[k],
                    "mean_s": round(self.totals[k] / self.counts[k], 4)}
                for k in sorted(self.totals)}

    def dump(self, path: Optional[str] = None) -> str:
        text = json.dumps(self.report(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text


_ACTIVE: Optional[Profiler] = None
_NOOP = contextlib.nullcontext()


@contextlib.contextmanager
def recording(prof: Optional[Profiler] = None) -> Iterator[Profiler]:
    """Make ``prof`` (a new Profiler when None) the active recorder for the
    block; the one active before it comes back after."""
    global _ACTIVE
    prof = Profiler() if prof is None else prof
    prev, _ACTIVE = _ACTIVE, prof
    try:
        yield prof
    finally:
        _ACTIVE = prev


def span(name: str):
    """A phase of the active recorder, or the shared no-op context."""
    prof = _ACTIVE
    return _NOOP if prof is None else prof.phase(name)


def count(key: str, n: int) -> None:
    """Set a counter of the innermost open span (nothing when no recorder
    is active)."""
    prof = _ACTIVE
    if prof is not None:
        prof.count(key, n)


def _sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals: overlapping ones
    count once."""
    total, hi = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= hi:
            continue
        total += e - max(s, hi)
        hi = e
    return total


def device_busy(fn) -> Tuple[float, float, list]:
    """One call of ``fn`` under ``torch.profiler`` with CPU and CUDA
    activity: (device busy seconds, wall seconds, the CUDA kernels'
    ``key_averages()`` entries). Busy is the union of the device
    operations' intervals, so kernels that overlap (programmatic dependent
    launch) count once; 1 - busy / wall is the device's idle share over the
    call, so ``fn`` must end in a synchronise (a host copy does)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_s = time.perf_counter() - t0
    on_device = lambda e: str(e.device_type).endswith("CUDA")
    kernels = [e for e in prof.key_averages() if on_device(e)]
    busy_s = union_length((e.time_range.start, e.time_range.end)
                          for e in prof.events() if on_device(e)) / 1e6
    return busy_s, wall_s, kernels


def block_and_time(fn, *args, n: int = 1, **kwargs):
    """Time a device function with synchronization: one warm-up call, then
    n calls each followed by ``torch.cuda.synchronize``. Returns (result,
    seconds_per_call)."""
    result = fn(*args, **kwargs)
    _sync()
    start = time.perf_counter()
    for _ in range(n):
        result = fn(*args, **kwargs)
        _sync()
    return result, (time.perf_counter() - start) / n
