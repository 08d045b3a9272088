"""Profiling & tracing: phase-scoped wall timers with a structured JSON
report, a ``torch.profiler`` trace of the card into a directory, and a
synchronizing timer. The port of the JAX package's ``utils/profiling.py``.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional


@dataclass
class Profiler:
    """Nested phase timers: with prof.phase('match'): ..."""
    totals: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    _stack: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        label = "/".join(self._stack + [name])
        self._stack.append(name)
        start = time.perf_counter()
        try:
            yield
        finally:
            self._stack.pop()
            self.totals[label] += time.perf_counter() - start
            self.counts[label] += 1

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


def _sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """``torch.profiler`` trace of the CPU and (where there is one) the
    card over the block, written to ``log_dir`` for TensorBoard's profiler
    plugin or Perfetto."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        _sync()


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
