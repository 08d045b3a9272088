"""One run of one cell: set-up, warm-up, the measured (or traced) window of
units sent through the mix's entry as its arrival process says (closed
loop in every cell so far), the comparison with the reference, and the
result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--rehearse]

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from ``traffic["trace_units"]`` units under
``torch.profiler``. ``--rehearse`` runs the cell on the CPU at the
configuration's ``rehearsal`` sizes, to find wrong paths and shapes: it
measures nothing and prints "not measured" for every metric. Without it a
run needs as many CUDA cards as the cell asks for, and exits 2 otherwise.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from . import data as bdata
from . import devtrace, judge, spec, system, yardstick

FORBIDDEN = ("jax", "jaxlib", "flax", "qpgesture_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux's /proc), else since the
    harness was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class Marks:
    """The traced window's marks (devtrace): a device-to-device copy whose
    byte count names it, queued at each edge of a unit's stages; their
    names are kept here in the order they were issued."""

    def __init__(self, encoder: system.Hooks, decoder: system.Hooks,
                 n_marks: int, device):
        size = devtrace.mark_bytes(n_marks)
        self.src = torch.zeros(size, dtype=torch.uint8, device=device)
        self.dst = torch.empty_like(self.src)
        self.units: List[List[str]] = []
        self.n = 0
        encoder.on_enter.append(lambda: self.mark("enc_start"))
        encoder.on_exit.append(lambda: self.mark("enc_end"))
        decoder.on_enter.append(lambda: self.mark("dec_start"))
        decoder.on_exit.append(lambda: self.mark("dec_end"))

    def mark(self, point: str):
        n = devtrace.mark_bytes(self.n)
        self.dst[:n].copy_(self.src[:n])
        self.n += 1
        self.units[-1].append(point)

    def start(self):
        self.units.append([])
        self.mark("start")


def _percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def _metric(cell: spec.Cell, name: str, lat: List[float], window_s: float,
            units: int, setup_s: float) -> float:
    entry = cell.entry
    own = getattr(entry, "end_to_end", None)
    v = own(name, lat, window_s, units) if own else None
    if v is not None:
        return v
    if name == "setup_s":
        return setup_s
    if name == "gesture_s_per_s":
        return units * yardstick.unit_windows(entry, cell.traffic) * 4.0 \
            / window_s
    prefix, q, unit = name.rsplit("_", 2)
    if prefix != entry.LATENCY or not q.startswith("p") or unit != "ms":
        raise ValueError(f"{cell.name} cannot report {name}")
    return _percentile(lat, float(q[1:])) * 1e3


def end_to_end(cell: spec.Cell, lat: List[float], window_s: float,
               units: int, setup_s: float) -> Dict[str, dict]:
    """The cell's end-to-end metrics: what the entry's own ``end_to_end``
    gives for a name, else setup_s, gesture_s_per_s (gesture seconds of
    every unit in the window over its seconds) or <LATENCY>_p<q>_ms (the
    q-th percentile of every unit's latency, LATENCY the entry's)."""
    return {m["name"]: {"value": _metric(cell, m["name"], lat, window_s,
                                         units, setup_s), "unit": m["unit"]}
            for m in cell.end_to_end}


def run(args) -> int:
    cell = spec.load_cell(args.workload, root=spec.ROOT,
                          rehearse=args.rehearse)
    if args.rehearse:
        device = torch.device("cpu")
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={n}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    cuda = device.type == "cuda"
    cfg, traffic, seed = cell.config, cell.traffic, args.seed
    model, entry = cell.model, cell.entry
    carries = hasattr(entry, "state")

    db = bdata.database(cfg, model, seed, device)
    prog = system.Program(cfg, model, entry, traffic, seed, device, db)
    first = start = None
    if carries:
        first = entry.first_carry(traffic, cfg, seed)
        start = tuple(system.host(x) for x in prog.state())
    enc_hooks = system.Hooks(prog.encoder)
    dec_hooks = system.Hooks(prog.decoder)

    def unit(i):
        return bdata.unit(traffic, entry, cfg, seed, i)

    warm = []
    for i in range(traffic["warmup_units"]):
        u = unit(-1 - i)
        t = time.perf_counter()
        prog.run(u)
        warm.append(time.perf_counter() - t)
    t_unit = min(warm[-2:])
    if args.trace:
        planned = n_low = traffic["trace_units"]
    else:
        planned = int(math.ceil(1.5 * args.seconds / t_unit)) + 4
        n_low = max(1, min(planned, int(0.5 * args.seconds / t_unit)))
    if cuda:
        torch.cuda.synchronize()
    # set-up ends with the warm-up: drawing the window's inputs is the
    # harness's own work, and its cost grows with planned (1 / t_unit)
    setup_s = process_age_s()
    t_setup = time.perf_counter()
    units = [unit(i) for i in range(planned)]
    sample = set(bdata.check_sample(traffic, seed, n_low))
    marks = prof = None
    if args.trace and cuda:
        marks = Marks(enc_hooks, dec_hooks, 6 * planned, device)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    if cuda:
        torch.cuda.synchronize()

    lat: List[float] = []
    records: List[judge.Record] = []
    failed = 0
    t0 = time.perf_counter()
    draw_s = t0 - t_setup
    deadline = t0 + args.seconds
    i = 0
    while True:
        u = units[i] if i < len(units) else unit(i)
        due = cell.arrivals.due(traffic, seed, i)
        if due is not None:
            due += t0
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        keep = i in sample
        enc_hooks.capture = keep
        before = prog.state() if keep and carries else None
        if marks:
            marks.start()
        ts = time.perf_counter()
        try:
            codes, poses = prog.run(u)
        except Exception:                  # a unit that fails is counted
            failed += 1
            if failed == 1:
                traceback.print_exc()
            codes = poses = None
        te = time.perf_counter()
        if marks:
            marks.mark("end")
        lat.append(te - (ts if due is None else due))
        enc_hooks.capture = False
        enc = enc_hooks.take()
        if keep and codes is not None:
            records.append(judge.Record(
                u, enc, codes, poses, before,
                prog.state() if carries else None))
        i += 1
        if (i >= planned) if args.trace else (te >= deadline):
            break
    window_s = te - t0
    if cuda:
        torch.cuda.synchronize()
    ctx = None
    if prof is not None:
        prof.__exit__(None, None, None)
        kernels, unit_marks, lost = devtrace.parse(
            devtrace.read_chrome_trace(prof), marks.units)
        if lost:
            print(f"the trace lost {lost} of {marks.n} marks",
                  file=sys.stderr)
        times = [t for m in unit_marks for t in m.values()]
        if not times:
            raise RuntimeError("the trace holds none of the marks")
        name = torch.cuda.get_device_name(device)
        ctx = devtrace.TraceContext(
            cell=cell.name, config=cfg, traffic=traffic, device_name=name,
            peaks=yardstick.peaks(name), units=i,
            window=(unit_marks[0].get("start", min(times)),
                    unit_marks[-1].get("end", max(times))),
            kernels=kernels, marks=unit_marks, model=model, entry=entry)
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the program's state goes before the reference runs
    for rec in records:
        rec.before = rec.before and tuple(system.host(x) for x in rec.before)
        rec.after = rec.after and tuple(system.host(x) for x in rec.after)
    enc_hooks.remove()
    dec_hooks.remove()
    del prog, enc_hooks, dec_hooks, units
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = judge.Reference(cfg, model, db, seed, device)
    values = judge.numbers(ref, entry, traffic, records, first, start)
    ref_s = time.perf_counter() - t_ref
    ok, checks = judge.check(values, cell.limits)
    correct = ok and failed == 0 and len(records) > 0
    readings = {k: v for k, v in values.items() if k not in cell.limits}

    if args.rehearse:
        metrics = {m["name"]: "not measured"
                   for m in (cell.per_layer if args.trace else cell.end_to_end)}
    elif args.trace:
        metrics = {}
        for m in cell.per_layer:
            read = spec.reader(m["name"], root=spec.ROOT)
            v = read(ctx) if read is not None else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = end_to_end(cell, lat, window_s, i, setup_s)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(peak_bytes)}
    if cuda:
        dev["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": i, "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace:
        if cuda:
            dev["busy_s"] = ctx.busy_s()
            dev["window_s"] = ctx.window_s
            result["breakdown"] = devtrace.breakdown(ctx)
        else:
            dev["busy_s"] = dev["window_s"] = "not measured"
    result["window"] = {"units": i, "seconds": window_s,
                        "marks_lost": lost if ctx is not None else None,
                        "setup_s": setup_s, "draw_s": draw_s,
                        "unit_s_median":
                        statistics.median(lat) if lat else None,
                        "checked_units": len(records), "reference_s": ref_s,
                        "readings": readings}
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, v in readings.items():
        print(f"reading {name} {v} (not compared)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true")
    return run(p.parse_args(argv))
