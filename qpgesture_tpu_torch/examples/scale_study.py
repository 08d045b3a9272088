"""Database-scale study: the card's matching time and memory against the
database size J.

The reference's published speaker databases hold a few hundred 4 s windows
each, and the bench's J=1024 already overshoots them; J=16384 approximates
all 30 BEAT speakers staged as one database. For each audio mode (wavvq:
K1 edit distances; wavlm: the shipped preset's cosine GEMM) and J this
reports, for one 24 s request (W=6) on the bench's data (``RandomState(0)``
drawn in the JAX package's order):

  * ``device_ms`` (tables + scan), ``tables_ms`` and ``fuse_scan_ms``:
    CUDA-event times (``utils/devtime.py``, calls queued back to back and
    differenced). The scan is a host loop of small launches, so its time
    includes the card's waits for the host, and ``idle_share`` (1 - busy /
    wall over one request under ``torch.profiler``) says how much;
  * ``gest_s_per_device_s``, and (wavvq) ``lev_gcells_per_s``;
  * ``db_hbm_mb``: the bytes of the engine's staged database tensors
    (``CodeKNNEngine.devdb``, the JAX example's ``_hbm_bytes(devdb)``); the
    port keeps its index tables (codes, blocks, window starts) in int64,
    torch's index type, where the JAX package keeps int32;
  * ``resident_mb``: the growth of ``torch.cuda.memory_allocated`` over
    the engine's construction and its first request: the database, the
    scan's phase grids (within ``QPG_PHASE_GRIDS_MAX_MB``) or phase / amp,
    the rank tables;
  * ``host_draw_s``: the host's time to draw the data.

Past one card, ``parallel/sharded_match.py`` splits J across ranks bit for
bit, so these are also per-rank numbers at J_total = J x ranks.

    python -m qpgesture_tpu_torch.examples.scale_study [J ...]
        [--modes=wavvq,wavlm] [--feat-dtype=float32|bfloat16|float16]
        [--device cuda]

(default J: 1024 4096 16384). A size that fails prints an "error" line
and the study goes on.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import bench
from ..device import resolve_device
from ..match.engine import CodeKNNEngine, DeviceMatchDB
from ..utils import devtime
from ..utils.profiling import device_busy

W = 6  # a 24 s clip


def devdb_bytes(devdb: DeviceMatchDB) -> int:
    """Bytes of every tensor the staged database holds (a split cosine
    database counts both halves)."""
    total = 0
    for name in DeviceMatchDB.__dataclass_fields__:
        x = getattr(devdb, name)
        for t in (x if isinstance(x, tuple) else (x,)):
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total


def stage(mode: str, J: int, feat_dtype: str = "float32"):
    """The bench's data for ``mode`` at J, staged on the host. Returns (cfg,
    db, test_audio, test_ctx, host_draw_s)."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    bundle, codes, signature = bench._build_common(rng, J)
    draws = bench._draw_mode(mode, rng, J, W)
    draw_s = time.perf_counter() - t0
    cfg, db, ta, tc = bench._stage_host(mode, bundle, codes, signature,
                                        draws, feat_dtype)
    return cfg, db, ta, tc, draw_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _allocated(device: torch.device) -> int:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" \
        else 0


def run(mode: str, J: int, peak: float = 0.0, feat_dtype: str = "float32",
        device="cuda", keep: dict = None) -> dict:
    """One (mode, J) row. ``keep``, when given, receives the request's
    codes under "codes" and the host-staged ``cfg``, ``db`` and queries
    ``test_audio`` / ``test_ctx`` (for a caller that checks them)."""
    dev = resolve_device(device)
    cfg, db, test_audio, test_ctx, draw_s = stage(mode, J, feat_dtype)
    _sync(dev)
    before = _allocated(dev)
    engine = CodeKNNEngine(cfg, db, device=dev)
    zero_phase = np.zeros((8, 16), np.float32)

    def request():
        codes, _, _, _ = engine.predict_device(
            test_audio, test_ctx, init_code=bench.INIT_CODE,
            init_phase=zero_phase)
        return codes.cpu().numpy()

    codes = request()
    _sync(dev)
    resident = _allocated(dev) - before
    if keep is not None:
        keep.update(codes=codes, cfg=cfg, db=db, test_audio=test_audio,
                    test_ctx=test_ctx)
    S = test_audio.shape[1]
    db_bytes = devdb_bytes(engine.devdb)
    out = {"mode": mode, "J": J, "feat_dtype": feat_dtype,
           "db_hbm_bytes": db_bytes,
           "db_hbm_mb": round(db_bytes / 2**20, 1),
           "resident_bytes": resident,
           "resident_mb": round(resident / 2**20, 1),
           "host_draw_s": round(draw_s, 2)}
    if dev.type != "cuda":
        return out  # the CPU has no device time

    ta, tc = engine.stage_queries(test_audio, test_ctx)
    rand_bits, resets = bench._scan_inputs(engine, W, S)

    def fn_predict():
        return engine.scan(engine.tables(ta, tc), S, 1, rand_bits,
                           resets)[0]

    pred_s, _ = devtime.device_seconds_per_iter(fn_predict, k_small=2,
                                                k_large=8, reps=5)
    tab_s, _ = devtime.device_seconds_per_iter(
        lambda: engine.tables(ta, tc), k_small=2, k_large=8, reps=5)
    busy_s, wall_s, _ = device_busy(request)
    flops, cells = bench._match_flops(cfg, db, W, S)
    out.update({
        "device_ms": round(pred_s * 1e3, 3),
        "tables_ms": round(tab_s * 1e3, 3),
        "fuse_scan_ms": round(max(pred_s - tab_s, 0.0) * 1e3, 3),
        "gest_s_per_device_s": round(W * 4.0 / pred_s, 1)
        if pred_s > 0 else None,
        "idle_share": round(1.0 - busy_s / wall_s, 4),
    })
    if cells and tab_s > 0:
        out["lev_gcells_per_s"] = round(cells / tab_s / 1e9, 2)
    if flops and tab_s > 0:
        out["tflops_effective"] = round(flops / tab_s / 1e12, 3)
        u = devtime.mfu(flops, tab_s, peak)
        if u is not None:
            out["mfu_bf16_peak"] = round(u, 4)
    return out


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sizes", nargs="*", type=int,
                   default=[1024, 4096, 16384])
    p.add_argument("--modes", default="wavvq,wavlm")
    p.add_argument("--feat-dtype", default="float32",
                   choices=["float32", "bfloat16", "float16"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    peak = devtime.peak_flops_per_s()[1] if torch.cuda.is_available() \
        else 0.0
    for mode in args.modes.split(","):
        for J in args.sizes:
            try:
                row = run(mode, J, peak, args.feat_dtype, args.device)
            except Exception as e:  # e.g. out of memory at the largest J
                msg = str(e).splitlines()[0][:200] if str(e) else repr(e)
                row = {"mode": mode, "J": J, "feat_dtype": args.feat_dtype,
                       "error": msg}
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
