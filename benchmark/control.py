"""The control of ``correct``: the plain reference put in the program's place
and computed at TF32, the precision below the configuration's float32 with
TF32 off, judged as a run judges the program. Its readings are the upper
ends the limits in ``limits/`` are set below (PERF.md gives them).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3
        [--rehearse]

prints one JSON line per seed with the numbers the cell compares. On the
card it runs at the cell's own sizes and as many units as a run checks;
``--rehearse`` runs the rehearsal sizes on the CPU, where ``judge.TF32``
rounds each product's operands to TF32 as the card's tensor cores would,
so the control fails there too.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import data as bdata  # noqa: E402
from benchmark import judge, spec  # noqa: E402


def readings(workload: str, seed: int, rehearse: bool = False) -> dict:
    cell = spec.load_cell(workload, rehearse=rehearse)
    device = torch.device("cpu" if rehearse else "cuda")
    cfg, traffic, entry = cell.config, cell.traffic, cell.entry
    db = bdata.database(cfg, cell.model, seed, device)
    ref = judge.Reference(cfg, cell.model, db, seed, device)
    first = entry.first_carry(traffic, cfg, seed) \
        if hasattr(entry, "state") else None
    ctl = judge.Control(ref, entry, traffic, first)
    start = ctl.state()
    records = [ctl.run(bdata.unit(traffic, entry, cfg, seed, i))
               for i in range(traffic["check_units"])]
    values = judge.numbers(ref, entry, traffic, records, first, start)
    ok, _ = judge.check(values, cell.limits)
    return {"workload": workload, "seed": seed, "control_correct": ok,
            **values}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rehearse", action="store_true")
    a = p.parse_args(argv)
    if not a.rehearse and not torch.cuda.is_available():
        print("the control runs on a CUDA card (TF32)", file=sys.stderr)
        return 2
    for s in a.seeds:
        print(json.dumps(readings(a.workload, s, a.rehearse)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
