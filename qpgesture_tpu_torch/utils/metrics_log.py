"""Persistent scalar-history sink for training runs.

The reference logs validation scalars to TensorBoard
(codebook/train.py:90-100); this is the dependency-free equivalent: an
append-only JSONL file of {"step", "epoch", "tag", "value"} rows plus a
reader that reassembles per-tag series — enough to judge a 500-epoch run
after the fact, diff two runs, or plot offline.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class ScalarHistory:
    """Append-only JSONL scalar sink.

    >>> hist = ScalarHistory(path)
    >>> hist.log(epoch=1, step=50, loss=0.3, fit=1.2)
    >>> ScalarHistory.read(path)["loss"]   # [(epoch, step, value), ...]
    """

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", buffering=1)  # line-buffered

    def log(self, epoch: int, step: int = 0, **scalars: float) -> None:
        t = time.time()
        for tag, value in scalars.items():
            row = {"t": t, "epoch": int(epoch), "step": int(step),
                   "tag": tag, "value": float(value)}
            self._f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def read(path: str) -> Dict[str, List[tuple]]:
        """Reassemble {tag: [(epoch, step, value), ...]} in write order."""
        series: Dict[str, List[tuple]] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                series.setdefault(row["tag"], []).append(
                    (row["epoch"], row["step"], row["value"]))
        return series

    @staticmethod
    def last(path: str, tag: str) -> Optional[float]:
        series = ScalarHistory.read(path).get(tag)
        return series[-1][2] if series else None
