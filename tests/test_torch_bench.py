"""The port's bench (qpgesture_tpu_torch/bench.py) against the JAX
package's root bench.py: the same staged database and requests from the
same seed, the same codes selected, the same analytic counts and
regression keys; the budget, the emission and the --check gate; the
refusal to run without a card or to take a TPU's snapshot as a target.
The sections' timings need the card (tests/test_torch_cuda.py and
chip_smoke.py phase 21); here they run on the CPU with devtime stubbed."""
import dataclasses
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from qpgesture_tpu_torch import bench as port_bench
from qpgesture_tpu_torch.core.config import VQVAEConfig
from qpgesture_tpu_torch.models.vqvae import VQVAE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J, W = 32, 2


@pytest.fixture(scope="module")
def jax_bench():
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    return bench


def _staged(mod, mode, **kw):
    rng = np.random.RandomState(0)
    common = mod._build_common(rng, J)
    staged = mod._stage_mode(mode, rng, J, W, *common, **kw)
    return common, staged, rng


@pytest.fixture(scope="module", params=["wavvq", "wavlm"])
def both(request, jax_bench):
    mode = request.param
    return (mode, _staged(jax_bench, mode),
            _staged(port_bench, mode, device="cpu"))


def _assert_same(a, b, what):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)
    else:
        assert a == b, what


def test_stage_mode_stages_the_jax_benchs_arrays(both):
    mode, (j_common, j_staged, j_rng), (p_common, p_staged, p_rng) = both
    for name, a, b in zip(("bundle", "codes", "signature"), j_common,
                          p_common):
        _assert_same(a, b, name)
    j_cfg, j_db, _, j_ta, j_tc = j_staged
    p_cfg, p_db, _, p_ta, p_tc = p_staged
    _assert_same(j_cfg, p_cfg, "cfg")
    _assert_same(j_db, p_db, "db")
    _assert_same(j_ta, p_ta, "test_audio")
    _assert_same(j_tc, p_tc, "test_ctx")
    # and the draws after the staging continue alike
    np.testing.assert_array_equal(j_rng.randn(4), p_rng.randn(4))


def test_predict_selects_the_jax_engines_codes(both):
    mode, (_, j_staged, _), (_, p_staged, _) = both
    zero = np.zeros((8, 16), np.float32)
    want = j_staged[2].predict(j_staged[3], j_staged[4], init_code=7,
                               init_phase=zero)
    got = p_staged[2].predict(p_staged[3], p_staged[4], init_code=7,
                              init_phase=zero)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.codes.shape == (W, 30)


def test_match_flops_counts_as_jax(both, jax_bench):
    mode, (_, j_staged, _), (_, p_staged, _) = both
    S = p_staged[3].shape[1]
    want = jax_bench._match_flops(j_staged[0], j_staged[1], W, S)
    got = port_bench._match_flops(p_staged[0], p_staged[1], W, S)
    assert got == want
    assert (got[1] > 0) == (mode == "wavvq") and got[0] > 0


def test_regression_keys_are_jaxs(jax_bench):
    assert port_bench._REGRESSION_KEYS == jax_bench._REGRESSION_KEYS
    assert port_bench.REGRESSION_FACTOR == jax_bench.REGRESSION_FACTOR
    assert port_bench.RUNS == jax_bench.RUNS
    assert port_bench.BASELINE == jax_bench.BASELINE


def _host_timer(fn, args=(), **_):
    fn(*args)
    return 1e-3, 0.0


def test_bench_mode_on_the_cpu_selects_jaxs_codes(monkeypatch, jax_bench):
    """The wavvq section end to end on the CPU, devtime's card timers
    stubbed: its request codes equal the JAX engine's on the JAX bench's
    data, its keys are the JAX section's and the device breakdown's."""
    monkeypatch.setattr(port_bench, "DEVICE", "cpu")
    monkeypatch.setattr(port_bench, "RUNS", 2)
    monkeypatch.setattr(port_bench.devtime, "device_seconds_per_iter",
                        _host_timer)
    rng = np.random.RandomState(0)
    common = port_bench._build_common(rng, J)
    model = VQVAE(VQVAEConfig(width=16, depth=1), device="cpu")
    out = port_bench._bench_mode("wavvq", rng, J, W, *common, model, 0.0)

    _, (_, _, engine, ta, tc), _ = _staged(jax_bench, "wavvq")
    want = engine.predict(ta, tc, init_code=7,
                          init_phase=np.zeros((8, 16), np.float32)).codes
    np.testing.assert_array_equal(np.asarray(out["codes"]), want)
    assert {"gest_s_per_s", "p50_ms", "p95_ms", "vs_baseline", "device",
            "batched_16clip"} <= set(out)
    assert {"device_ms", "tables_ms", "fuse_scan_ms", "decode_ms",
            "match_flops", "lev_cells", "lev_gcells_per_s",
            "idle_share"} <= set(out["device"])
    # a CPU run has no device time: the profiler sees no kernel
    assert out["device"]["idle_share"] == 1.0
    json.dumps(out)


# ---- the budget, the emission and --check, with every section stubbed ----

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _stub_sections(monkeypatch, clock, cost_s=None):
    """Stub the card and every section; a section advances the clock by
    its cost (seconds) and returns a section of the real one's keys."""
    cost_s = cost_s or {}

    def spend(name):
        clock.t += cost_s.get(name, 0.0)

    device = {"device_ms": 3.0, "tables_ms": 1.0, "fuse_scan_ms": 1.5,
              "decode_ms": 0.5, "gest_s_per_device_s": 8000.0,
              "match_flops": 1e9, "idle_share": 0.9,
              "tflops_effective": 0.1, "mfu_bf16_peak": 1e-4}

    def mode(name, *args):
        spend(name)
        out = {"gest_s_per_s": 500.0, "p50_ms": 48.0, "p95_ms": 50.0,
               "vs_baseline": 6250.0, "codes": [[1] * 30] * 6,
               "device": dict(device, lev_cells=1e9, lev_gcells_per_s=10.0)
               if name == "wavvq" else
               dict(device, tables_ms_high=1.2, tables_ms_default=0.8)}
        if name == "wavvq":
            out["batched_16clip"] = {"gest_s_per_s": 3000.0,
                                     "p50_ms": 128.0, "vs_baseline": 4e4,
                                     "device_ms": 120.0,
                                     "gest_s_per_device_s": 3200.0}
        return out

    def rawwav(name, peak):
        spend(f"rawwav:{name}")
        return {"mode": name, "e2e_p50_ms": 60.0, "device_ms": 55.0,
                "enc_ms": 20.0, "match_ms": 30.0, "decode_ms": 5.0,
                "gest_s_per_s": 400.0, "gest_s_per_device_s": 436.0,
                "first_call_wall_s": 9.0, "flops": 1e12,
                "tflops_effective": 18.0, "mfu_bf16_peak": 0.018}

    def section(name, value):
        def run(*args):
            spend(name)
            return value
        return run

    monkeypatch.setattr(port_bench, "J", 8)
    monkeypatch.setattr(port_bench, "_card",
                        lambda: ("NVIDIA H100 80GB HBM3", 989e12, 1e-5,
                                 "700.00 W"))
    monkeypatch.setattr(port_bench, "_decoder", lambda rng: None)
    monkeypatch.setattr(port_bench, "_bench_mode", mode)
    monkeypatch.setattr(port_bench, "_bench_rawwav", rawwav)
    monkeypatch.setattr(port_bench, "_bench_train", section(
        "train_vqvae", {"step_ms_p50": 97.0, "windows_per_s": 2600.0,
                        "device_ms_per_step": 96.0,
                        "windows_per_device_s": 2660.0,
                        "flops_per_step": 3e12, "tflops_effective": 31.0,
                        "mfu_bf16_peak": 0.03,
                        "bf16_variant": {"device_ms_per_step": 40.0,
                                         "windows_per_device_s": 6400.0,
                                         "mfu_bf16_peak": 0.07}}))
    monkeypatch.setattr(port_bench, "_bench_rawpose", section(
        "rawpose_knn_batch16", {"p50_ms": 30.0, "gest_s_per_s": 2100.0,
                                "n_seqs": 16}))
    monkeypatch.setattr(port_bench, "_bench_pae", section(
        "pae_extract", {"frames": 8192, "p50_ms": 50.0,
                        "frames_per_s": 160000.0}))
    monkeypatch.setattr(port_bench, "_clock", clock)


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


SECTIONS = ["wavvq", "wavlm", "train_vqvae", "rawpose_knn_batch16",
            "pae_extract", "rawwav:wavvq", "rawwav:wavlm_split:default"]


def test_every_section_emits_a_compact_line(tmp_path, monkeypatch, capsys):
    clock = _Clock()
    _stub_sections(monkeypatch, clock)
    monkeypatch.delenv("QPG_BENCH_RAWWAV_MODES", raising=False)
    full_out = str(tmp_path / "full.json")
    full = port_bench.main(["--full-out", full_out])
    lines = _lines(capsys)
    # the set-up line, one line a section, the final line
    assert len(lines) == 1 + len(SECTIONS) + 1
    assert lines[0]["pending"] == ["setup"] and lines[0]["value"] is None
    assert lines[1]["pending"] == SECTIONS[1:]
    assert "wavvq" in lines[1] and "wavlm" not in lines[1]
    final = lines[-1]
    assert final == port_bench._compact(full)
    assert "pending" not in final and "skipped" not in final
    assert final["value"] == 500.0
    assert final["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert final["power_limit"] == "700.00 W"
    assert final["wavvq"]["device"]["idle_share"] == 0.9
    assert set(final["rawwav"]) == {"wavvq", "wavlm_split:default"}
    assert "codes" not in final["wavvq"]
    assert len(json.dumps(final)) < 2200
    # every regression key survives compaction, and the line is checkable
    for name, path in port_bench._REGRESSION_KEYS:
        assert port_bench._dig(final, path) == port_bench._dig(full, path)
    assert port_bench.check_regressions(final, final) == []
    # the full detail is on disk
    disk = json.loads(open(full_out).read())
    assert disk["wavvq"]["codes"] == full["wavvq"]["codes"]
    assert disk["wavlm"]["device"]["tables_ms_high"] == 1.2


def test_budget_skips_what_it_has_no_time_for(tmp_path, monkeypatch,
                                              capsys):
    """The budget starts when the bench starts: 300 s; wavvq and wavlm
    take 100 s each, so the raw-wav probe (120 s reserve) is skipped and
    training (90) runs; after it nothing fits."""
    clock = _Clock()
    _stub_sections(monkeypatch, clock, {"wavvq": 100.0, "wavlm": 100.0,
                                        "train_vqvae": 100.0})
    monkeypatch.setenv("QPG_BENCH_BUDGET_S", "300")
    monkeypatch.delenv("QPG_BENCH_RAWWAV_MODES", raising=False)
    full = port_bench.main(["--full-out", str(tmp_path / "f.json")])
    lines = _lines(capsys)
    assert full["skipped"] == ["rawwav:wavvq", "rawpose_knn_batch16",
                               "pae_extract", "rawwav:wavlm_split:default"]
    assert "pending" not in full and full["elapsed_s"] == 300.0
    assert "train_vqvae" in full and "rawwav" not in full
    # the line after wavlm still lists the sections to come
    assert lines[2]["pending"] == ["train_vqvae", "rawpose_knn_batch16",
                                   "pae_extract", "rawwav:wavvq",
                                   "rawwav:wavlm_split:default"]
    assert lines[-1]["skipped"] == full["skipped"]

    clock.t = 0.0
    monkeypatch.setenv("QPG_BENCH_BUDGET_S", "0")
    monkeypatch.setenv("QPG_BENCH_RAWWAV_MODES", "wavlm:high")
    full = port_bench.main(["--full-out", str(tmp_path / "f.json")])
    # skipped in the order the sections run: the first raw-wav mode right
    # after the core modes
    assert full["skipped"] == SECTIONS[:2] + ["rawwav:wavlm:high"] + \
        SECTIONS[2:5]
    assert full["value"] is None


@pytest.mark.parametrize("mode,ok", [
    ("wavvq", True), ("wavvq_split", True), ("wavlm", True),
    ("wavlm_split:default", True), ("wavlm:high", True),
    ("wavvq:default", False), ("wavlm:fast", False), ("mfcc", False)])
def test_rawwav_modes_parse_as_jax_names_them(mode, ok, tmp_path,
                                              monkeypatch):
    if ok:
        base = port_bench._rawwav_mode(mode)[0]
        assert base == mode.split(":")[0].replace("_split", "")
        return
    # a bad mode fails before any device work, card or not
    monkeypatch.setenv("QPG_BENCH_RAWWAV_MODES", f"wavvq,{mode}")
    with pytest.raises(ValueError, match="raw-wav mode"):
        port_bench.main(["--full-out", str(tmp_path / "f.json")])


def _snapshot(path, kind="NVIDIA H100 80GB HBM3", device_ms=3.0, wrap=None):
    line = {"metric": port_bench.METRIC, "device_kind": kind,
            "wavvq": {"device": {"device_ms": device_ms, "tables_ms": 1.0}},
            "train_vqvae": {"device_ms_per_step": 96.0}}
    obj = line
    if wrap == "parsed":
        obj = {"rc": 0, "parsed": line}
    elif wrap == "tail":
        obj = {"rc": 0, "tail": "benchmarking wavvq...\n" + json.dumps(line)
               + "\nnoise"}
    path.write_text(json.dumps(obj))
    return str(path)


@pytest.mark.parametrize("wrap", [None, "parsed", "tail"])
def test_load_snapshot_takes_the_benchs_own_lines(tmp_path, wrap):
    snap = port_bench.load_snapshot(_snapshot(tmp_path / "s.json",
                                              wrap=wrap))
    assert snap["wavvq"]["device"]["device_ms"] == 3.0


def test_load_snapshot_refuses_a_tpus(tmp_path):
    with pytest.raises(ValueError, match="names no CUDA card"):
        port_bench.load_snapshot(_snapshot(tmp_path / "s.json",
                                           kind="TPU v5 lite"))
    # the JAX bench's snapshots are a TPU's: none is a target
    shipped = sorted(glob.glob(os.path.join(REPO, "BENCH_r*.json"))) + [
        os.path.join(REPO, "bench_full.json")]
    assert len(shipped) >= 6
    for path in shipped:
        with pytest.raises(ValueError):
            port_bench.load_snapshot(path)
    with pytest.raises(ValueError, match="names no CUDA card"):
        port_bench.load_snapshot(os.path.join(REPO, "bench_full.json"))


def test_check_exit_codes(tmp_path, monkeypatch, capsys):
    """--check: 2 for a missing, unparseable or TPU snapshot (before any
    device work), 1 for a regression past the factor, else the dict with
    its (empty) regressions."""
    out = ["--full-out", str(tmp_path / "f.json")]
    garbage = tmp_path / "garbage.json"
    garbage.write_text("not json")
    for snap in (str(tmp_path / "missing.json"), str(garbage),
                 _snapshot(tmp_path / "tpu.json", kind="TPU v5 lite")):
        with pytest.raises(SystemExit) as e:
            port_bench.main(out + ["--check", snap])
        assert e.value.code == 2

    _stub_sections(monkeypatch, _Clock())
    monkeypatch.delenv("QPG_BENCH_RAWWAV_MODES", raising=False)
    # the stub's wavvq device_ms is 3.0: 2.4 x 1.2 < 3.0 regresses
    with pytest.raises(SystemExit) as e:
        port_bench.main(out + ["--check", _snapshot(tmp_path / "slow.json",
                                                    device_ms=2.4)])
    assert e.value.code == 1
    last = _lines(capsys)[-1]
    assert last["checked_against"] == "slow.json"
    assert len(last["regressions"]) == 1 and \
        "wavvq.device.device_ms" in last["regressions"][0]

    full = port_bench.main(out + ["--check", _snapshot(tmp_path / "ok.json",
                                                       device_ms=2.6)])
    assert full["regressions"] == [] and full["checked_against"] == "ok.json"


def test_cli_bench_without_a_card_exits_with_the_device_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the bench would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "qpgesture_tpu_torch.cli", "bench"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    # nothing measured, nothing written
    assert not proc.stdout.strip()
    assert not os.listdir(tmp_path)
