"""The traced window: ``torch.profiler``'s device records (CUDA activity
only, so the host runs at its untraced pace) and the marks the benchmark
puts on the device stream at the edges of each unit's stages.

A mark is a device-to-device copy whose byte count names it (the k-th
mark of the window copies ``mark_bytes(k)`` bytes, an odd count above a
MiB), queued when the unit starts, when the encoder module's forward
starts and ends (forward hooks), when the decoder module's does, and when
the unit returns. The device runs one stream in order, so a kernel belongs
to the stage whose mark precedes it, and the gap between two marks is
card-clock time. A mark the trace lost is known by its missing count, and
the stage before it runs on. ``TraceContext`` is what each per-layer
metric's reader takes."""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import yardstick

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK_BASE = (1 << 20) + 1


def mark_bytes(k: int) -> int:
    """Bytes the k-th mark copies."""
    return MARK_BASE + 2 * k


def _mark_index(e: dict, n: int) -> Optional[int]:
    b = e.get("args", {}).get("bytes") if e.get("cat") == "gpu_memcpy" \
        else None
    if b is None or b < MARK_BASE or (b - MARK_BASE) % 2:
        return None
    k = (b - MARK_BASE) // 2
    return k if k < n else None
# the stage a unit is in after each mark
STAGE_AFTER = {"start": "unit", "enc_start": "encoder", "enc_end": "match",
               "dec_start": "decode", "dec_end": "return", "end": "client"}


@dataclass
class Kernel:
    name: str
    start: float                  # seconds, the trace's clock
    end: float
    stage: str                    # the unit's stage it ran in


@dataclass
class TraceContext:
    """What a per-layer metric's reader is given."""
    cell: str
    config: dict
    traffic: dict
    device_name: str
    peaks: Optional[dict]
    units: int                    # units traced
    window: Tuple[float, float]   # first unit's start mark, last's end mark
    kernels: List[Kernel]
    # per unit, the seconds of each mark on the trace's clock
    marks: List[Dict[str, float]] = field(default_factory=list)
    model: Any = None             # models/<model>.py of the configuration
    entry: Any = None             # entries/<entry>.py of the mix

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_seconds(self, stage: Optional[str] = None,
                       name_has: Optional[str] = None) -> float:
        """Device seconds of the kernels of ``stage`` whose names hold
        ``name_has``: the union of their intervals, since kernels of one
        stream overlap where a kernel starts before its predecessor ends
        (programmatic dependent launch)."""
        return yardstick.union_seconds(
            ((k.start, k.end) for k in self.kernels
             if (stage is None or k.stage == stage)
             and (name_has is None or name_has in k.name)),
            -float("inf"), float("inf"))

    def busy_s(self) -> float:
        return yardstick.union_seconds(
            ((k.start, k.end) for k in self.kernels), *self.window)


def read_chrome_trace(prof) -> dict:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def parse(trace: dict, issued: List[List[str]]
          ) -> Tuple[List[Kernel], List[Dict[str, float]], int]:
    """Device operations with their stage, each unit's marks, and how many
    marks the trace lost, from a chrome trace and the marks the host
    issued (per unit, in order)."""
    ops = sorted((e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    names = [(u, p) for u, unit in enumerate(issued) for p in unit]
    marks: List[Dict[str, float]] = [{} for _ in issued]
    kernels, stage = [], "client"
    for e in ops:
        t0 = e["ts"] * 1e-6
        k = _mark_index(e, len(names))
        if k is not None:
            u, p = names[k]
            marks[u][p] = t0
            stage = STAGE_AFTER[p]
            continue
        kernels.append(Kernel(e["name"], t0, t0 + e["dur"] * 1e-6, stage))
    found = sum(len(m) for m in marks)
    return kernels, marks, len(names) - found


def breakdown(ctx: TraceContext, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the stage whose work ends them, the stage the host was launching
    (``client``: between units)."""
    lo, hi = ctx.window
    by_name: Dict[str, float] = defaultdict(float)
    for k in ctx.kernels:
        if lo <= k.start < hi:
            by_name[k.name] += k.end - k.start
    stage_at = sorted((t, STAGE_AFTER[p]) for unit in ctx.marks
                      for p, t in unit.items())
    gaps = yardstick.idle_gaps([(k.start, k.end) for k in ctx.kernels],
                               lo, hi)
    by_stage: Dict[str, float] = defaultdict(float)
    j, stage = 0, "client"
    for s, e in gaps:
        while j < len(stage_at) and stage_at[j][0] <= e:
            stage = stage_at[j][1]
            j += 1
        by_stage[stage] += e - s
    rank = lambda d: [[n, v] for n, v in sorted(d.items(),
                                                key=lambda x: -x[1])[:top]]
    return {"device_ops": rank(by_name), "idle_gaps": rank(by_stage)}
