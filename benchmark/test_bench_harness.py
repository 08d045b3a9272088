"""The harness on the CPU: each cell rehearsed end to end at its
configuration's rehearsal sizes, a cell, mix, limits and metric added as
data alone, the end-to-end metrics' arithmetic, the refusal without a
card or without the program, and no JAX among the harness's imports."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, spec

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELLS = ["wavlm-large-j1024.pool16", "vq-wav2vec-j16384.batch16",
         "wavlm-large-j1024.clip", "vq-wav2vec-j16384.clip"]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(capsys, *argv):
    rc = harness.main(list(argv))
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_of_each_cell(capsys, cell):
    rc, r = _run(capsys, "--workload", cell, "--seed", str(2 ** 31 + 5),
                 "--seconds", "0.5", "--trace", "0", "--rehearse")
    assert rc == 0 and r["correct"] and r["failed"] == 0
    assert r["attempted"] >= 1 and r["window"]["checked_units"] >= 1
    want = {m["name"] for m in spec.load_cell(cell).end_to_end}
    assert r["metrics"] == {n: "not measured" for n in want}
    assert list(r)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("seconds", ["0.5", "2"])
def test_setup_s_is_read_before_the_window_inputs_are_drawn(
        capsys, monkeypatch, seconds):
    """setup_s ends with the warm-up: none of the window's units (index 0
    and up; warm-up units have negative ones) is drawn before it is read,
    so it does not grow with planned; draw_s holds what the draw cost."""
    drawn, at_setup = [], []
    draw = harness.bdata.unit

    def logged(traffic, entry, cfg, seed, index):
        if index >= 0:
            drawn.append(index)
        return draw(traffic, entry, cfg, seed, index)

    age = harness.process_age_s

    def recorded():
        at_setup.append(len(drawn))
        return age()

    monkeypatch.setattr(harness.bdata, "unit", logged)
    monkeypatch.setattr(harness, "process_age_s", recorded)
    rc, r = _run(capsys, "--workload", "vq-wav2vec-j16384.clip", "--seed",
                 str(2 ** 31 + 77), "--seconds", seconds, "--trace", "0",
                 "--rehearse")
    assert rc == 0 and r["correct"]
    assert at_setup == [0]
    assert len(drawn) >= r["attempted"]
    assert r["window"]["draw_s"] >= 0


def test_traced_rehearsal_measures_nothing(capsys):
    rc, r = _run(capsys, "--workload", "wavlm-large-j1024.clip", "--seed",
                 "11", "--seconds", "1", "--trace", "1", "--rehearse")
    assert rc == 0 and r["correct"]
    assert r["attempted"] == spec.load_cell(
        "wavlm-large-j1024.clip").traffic["trace_units"]
    assert set(r["metrics"].values()) == {"not measured"}
    assert r["device"]["busy_s"] == "not measured"


def test_measured_run_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc, r = _run(capsys, "--workload", "vq-wav2vec-j16384.clip", "--seed",
                 "1", "--seconds", "1", "--trace", "0")
    assert rc == 2 and r is None


def _data_root(tmp_path):
    """A copy of the benchmark with one more cell, mix, limits file and
    per-layer metric, added as files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"].append(
        {"name": "wavlm-large-j1024.pool4", "config": "wavlm-large-j1024",
         "traffic": "pool4", "chips": 1, "why": "4 streams"})
    for m in bench["end_to_end"]:
        if m["name"] == "tick_p95_ms":
            m["workloads"].append("wavlm-large-j1024.pool4")
    bench["per_layer"].append(
        {"name": "ticks_traced.tick", "unit": "ticks", "better": "higher",
         "source": "program_counter", "layer": "whole unit",
         "moves": "tick_p95_ms", "workloads": ["wavlm-large-j1024.pool4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.load(open(os.path.join(HERE, "traffic", "pool16.json")))
    traffic.update(streams=4, check_units=2, trace_units=3)
    (root / "benchmark" / "traffic" / "pool4.json").write_text(
        json.dumps(traffic))
    shutil.copy(os.path.join(HERE, "limits", "wavlm-large-j1024.pool16.json"),
                root / "benchmark" / "limits" / "wavlm-large-j1024.pool4.json")
    (root / "benchmark" / "metrics" / "ticks_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    return root


def test_a_cell_added_as_data_alone(tmp_path, capsys, monkeypatch):
    root = _data_root(tmp_path)
    cell = spec.load_cell("wavlm-large-j1024.pool4", root=str(root),
                          rehearse=True)
    assert cell.traffic["streams"] == 4
    assert [m["name"] for m in cell.end_to_end] == ["tick_p95_ms",
                                                    "setup_s"]
    assert "ticks_traced.tick" in [m["name"] for m in cell.per_layer]
    read = spec.reader("ticks_traced.tick", root=str(root))
    assert read(type("Ctx", (), {"units": 3})) == 3.0
    # the base name's reader serves a split it has not seen
    assert spec.reader("encoder_ms.anything", root=str(root)) is not None
    monkeypatch.setattr(spec, "ROOT", str(root))
    rc, r = _run(capsys, "--workload", "wavlm-large-j1024.pool4", "--seed",
                 "9", "--seconds", "0.3", "--trace", "0", "--rehearse")
    assert rc == 0 and r["correct"] and r["attempted"] >= 1


ENTRY = """
\"\"\"A client that sends its clips one after another through serve.\"\"\"
import numpy as np
from benchmark import judge

LATENCY = "burst"


def lead(traffic):
    return (traffic["clips"], traffic["windows"])


def clips(traffic):
    return traffic["clips"]


def build(prog, traffic, cfg, seed):
    return prog.server


def call(server, u):
    out = [server.serve(u.wav[c], u.context[c],
                        init_code=int(u.init_codes[c]),
                        init_phase=u.init_phases[c])
           for c in range(len(u.init_codes))]
    return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out]))


def end_to_end(name, lat, window_s, units):
    return units / window_s if name == "bursts_per_s" else None


fuse = judge.fuse_clips
"""

ARRIVALS = """
\"\"\"Poisson arrivals at the mix's rate_per_s.\"\"\"
import numpy as np


def due(traffic, seed, i):
    r = np.random.default_rng([seed, 7])
    return float(r.exponential(1.0 / traffic["rate_per_s"], i + 1).sum())
"""


def test_a_mix_with_a_new_entry_and_arrivals_added_as_files_alone(
        tmp_path, capsys, monkeypatch):
    """A mix that drives the program through an entry and an arrival
    process the benchmark did not have, added as files and entries."""
    root = _data_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = "wavlm-large-j1024.each2"
    bench["workloads"].append(
        {"name": cell, "config": "wavlm-large-j1024", "traffic": "each2",
         "chips": 1, "why": "two clips a burst, Poisson arrivals"})
    for name, unit in (("burst_p50_ms", "ms"), ("bursts_per_s", "1/s")):
        bench["end_to_end"].insert(0, {
            "name": name, "unit": unit, "better": "lower", "bound": 0.05,
            "source": "host_clock", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    b = root / "benchmark"
    (b / "entries" / "serve_each.py").write_text(ENTRY)
    (b / "arrivals" / "poisson.py").write_text(ARRIVALS)
    traffic = json.load(open(os.path.join(HERE, "traffic", "batch16.json")))
    traffic.update(entry="serve_each", arrivals="poisson", rate_per_s=20,
                   clips=2, windows=2, warmup_units=2, check_units=2,
                   trace_units=2)
    (b / "traffic" / "each2.json").write_text(json.dumps(traffic))
    shutil.copy(os.path.join(HERE, "limits", "wavlm-large-j1024.clip.json"),
                b / "limits" / (cell + ".json"))
    c = spec.load_cell(cell, root=str(root), rehearse=True)
    assert c.entry.LATENCY == "burst" and c.arrivals.due(traffic, 1, 0) > 0
    monkeypatch.setattr(spec, "ROOT", str(root))
    rc, r = _run(capsys, "--workload", cell, "--seed", "2718281828",
                 "--seconds", "0.5", "--trace", "0", "--rehearse")
    assert rc == 0 and r["correct"] and r["attempted"] >= 1
    assert r["metrics"] == {"burst_p50_ms": "not measured",
                            "bursts_per_s": "not measured",
                            "setup_s": "not measured"}
    assert set(r["checks"]) == {"enc_rel_err", "code_diff", "pose_err"}
    assert r["window"]["readings"]["code_diff_own"] == 0
    lat = [0.1, 0.2, 0.3]
    m = harness.end_to_end(c, lat, 1.0, 3, 2.0)
    assert m["burst_p50_ms"]["value"] == pytest.approx(200.0)
    assert m["bursts_per_s"]["value"] == pytest.approx(3.0)


def test_end_to_end_arithmetic():
    cell = spec.load_cell("wavlm-large-j1024.clip")
    lat = [0.001 * i for i in range(1, 101)]
    m = harness.end_to_end(cell, lat, 10.0, 100, 12.5)
    assert m["clip_p50_ms"]["value"] == pytest.approx(50.5)
    assert m["clip_p95_ms"]["value"] == pytest.approx(95.05)
    assert m["setup_s"] == {"value": 12.5, "unit": "s"}
    cell = spec.load_cell("vq-wav2vec-j16384.batch16")
    m = harness.end_to_end(cell, lat, 10.0, 25, 1.0)
    # 25 batches of 16 clips x 6 windows x 4 s in 10 s
    assert m["gesture_s_per_s"]["value"] == pytest.approx(25 * 96 * 4 / 10)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    fake = dict(sys.modules)
    fake.update({"qpgesture_tpu_torch.serve": None, "jaxtyping": None,
                 "flaxy": None})
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    fake.update({"qpgesture_tpu.match.engine": None, "jax.numpy": None})
    assert harness.forbidden_modules() == ["jax.numpy",
                                           "qpgesture_tpu.match.engine"]


def test_harness_imports_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import glob, os\n"
        "from benchmark import control, harness, spec, system\n"
        "for kind in ('metrics', 'models', 'entries', 'arrivals'):\n"
        "    for f in glob.glob(os.path.join(sys.argv[1], 'benchmark', "
        "kind, '*.py')):\n"
        "        spec.plugin(kind, os.path.basename(f)[:-3])\n"
        "import qpgesture_tpu_torch.serve, qpgesture_tpu_torch.models.wavlm\n"
        "import qpgesture_tpu_torch.models.vq_wav2vec\n"
        "print(harness.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, ROOT], cwd=ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_refuses_in_a_checkout_without_the_program(tmp_path):
    root = tmp_path / "bare"
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "vq-wav2vec-j16384.clip", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--rehearse"], cwd=root, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
