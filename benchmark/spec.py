"""What a cell is made of, found by name from ``BENCHMARK.json``:

  * ``configs/...`` as the configuration entry names it, and
    ``models/<model>.py`` for the encoder the configuration's ``model``
    names (weights, the port's module, the reference's forward, its check,
    its work);
  * ``traffic/<mix>.json``, the mix's parameters, which the one generator
    in ``data.py`` reads; ``entries/<entry>.py`` for the program entry the
    mix's ``entry`` names (its unit's layout, the call, what it carries
    and how the reference follows it); ``arrivals/<arrivals>.py`` for when
    each unit is sent (``closed`` when the mix names none);
  * ``limits/<cell>.json``, the limits of the numbers compared;
  * ``metrics/<metric>.py`` for each per-layer metric (or, when no file
    bears the whole name, ``metrics/<name before the first dot>.py``).

A later configuration, mix, entry, arrival process or metric is added as
files and entries, with no edit here."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DIR = os.path.basename(HERE)            # the benchmark's folder in a root

_LOADED: Dict[str, ModuleType] = {}


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(base: dict, over: dict) -> dict:
    """base with over's keys laid on top, nested groups merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def plugin(kind: str, name: str, root: str = ROOT) -> Optional[ModuleType]:
    """The module ``<root>/benchmark/<kind>/<name>.py``, or None."""
    path = os.path.join(root, DIR, kind, name + ".py")
    if not os.path.exists(path):
        return None
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_{name}".replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def _need(kind: str, name: str, root: str) -> ModuleType:
    mod = plugin(kind, name, root)
    if mod is None:
        raise KeyError(f"no {DIR}/{kind}/{name}.py in {root}")
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    model: ModuleType           # models/<config's model>.py
    entry: ModuleType           # entries/<mix's entry>.py
    arrivals: ModuleType        # arrivals/<mix's arrivals>.py


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, root: str = ROOT, rehearse: bool = False) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json. With ``rehearse``,
    the configuration's ``rehearsal`` sizes replace its own."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    if rehearse:
        config = merge(config, config.get("rehearsal", {}))
    here = os.path.join(root, DIR)
    traffic = _load_json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    limits = _load_json(os.path.join(here, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    layers = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, layers,
                model=_need("models", config["model"], root),
                entry=_need("entries", traffic["entry"], root),
                arrivals=_need("arrivals", traffic.get("arrivals", "closed"),
                               root))


def reader(metric: str, root: str = ROOT):
    """The ``read(ctx)`` function of a per-layer metric, or None."""
    for stem in (metric, metric.split(".")[0]):
        mod = plugin("metrics", stem, root)
        if mod is not None:
            return mod.read
    return None
