"""Device time and operation counts on the card.

The counterparts of the JAX package's ``utils/devtime.py``:

  * ``device_seconds_per_iter`` — device seconds per call of ``fn(*args)``:
    CUDA events around k_small and k_large calls queued back to back,
    differenced so the fixed cost of a timed run cancels; with ``graph``
    (for a ``fn`` that can be captured: no host sync, no CPU tensors) the
    calls are replays of one CUDA graph of it, else eager calls;
  * ``chained_seconds_per_iter`` — the same for self-chaining steps
    (training): ``step(carry, *extras[, x_i]) -> (carry, ...)``;
  * ``measure_link_s`` — the launch floor: host seconds from launching an
    empty kernel to seeing it finish;
  * ``cost_analysis_flops`` — the floating-point operations of a call,
    counted by a dispatch mode that applies torch's own per-operator
    formulas (``torch.utils.flop_counter``'s registry). Unlike
    ``FlopCounterMode`` it installs no module hooks, so a double-backward
    graph (``autograd.grad(create_graph=True)`` on a leaf input) counts
    too;
  * ``peak_flops_per_s`` — the card's dense peak for a dtype, by
    ``torch.cuda.get_device_name``;
  * ``mfu`` — achieved operations over that peak.

A path that finds no card raises: a CPU run has no device time.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit:
# float32 outside the tensor cores, and the tensor cores' 16-bit and TF32
# rates, FLOP/s.
H100_SXM_PEAKS = {"float32": 67e12, "tfloat32": 495e12,
                  "bfloat16": 989e12, "float16": 989e12}


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device; a CPU run has "
                           "no device time")


def peak_flops_per_s(dtype: str = "bfloat16", device=None
                     ) -> Tuple[str, float]:
    """(device name, dense peak FLOP/s for ``dtype``): the H100 SXM data
    sheet's rates for an H100 other than the PCIe part; 0.0 for any other
    device, so that callers omit a utilization rather than invent one."""
    name = torch.cuda.get_device_name(device) \
        if torch.cuda.is_available() else "cpu"
    if "H100" in name and "PCIe" not in name:
        return name, H100_SXM_PEAKS[dtype]
    return name, 0.0


def mfu(flops: float, seconds: float, peak: float) -> Optional[float]:
    """Achieved over peak FLOP/s; None when the peak is unknown."""
    if not peak or seconds <= 0:
        return None
    return flops / seconds / peak


def _events_ms(run: Callable[[], None]) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _differenced(run_k: Callable[[int], None], k_small: int, k_large: int,
                 reps: int) -> float:
    """Median over reps of (time of k_large - time of k_small) /
    (k_large - k_small), in seconds; never below 0 nor above the k_large
    run's mean."""
    per = []
    for _ in range(reps):
        t_s = _events_ms(lambda: run_k(k_small))
        t_l = _events_ms(lambda: run_k(k_large))
        d = (t_l - t_s) / (k_large - k_small)
        per.append(min(max(d, 0.0), t_l / k_large))
    return statistics.median(per) / 1e3


def _capture(fn: Callable, args: Sequence) -> torch.cuda.CUDAGraph:
    """A CUDA graph of one call of fn(*args), warmed up on a side stream as
    capture requires."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(*args)
    return graph


def device_seconds_per_iter(fn: Callable, args: Sequence = (),
                            k_small: int = 4, k_large: int = 16,
                            reps: int = 5, graph: bool = False
                            ) -> Tuple[float, float]:
    """Device seconds per call of ``fn(*args)`` (args already on the card).

    Returns (seconds_per_iter, warm-up seconds). With ``graph`` the call is
    captured once and replayed, which takes the host's launch time out from
    between the kernels; otherwise eager calls are queued back to back."""
    _require_cuda()
    t0 = time.perf_counter()
    for _ in range(3):
        fn(*args)
    g = _capture(fn, args) if graph else None
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if g is not None:
        def run_k(k):
            for _ in range(k):
                g.replay()
    else:
        def run_k(k):
            for _ in range(k):
                fn(*args)
    return _differenced(run_k, k_small, k_large, reps), warm_s


def chained_seconds_per_iter(step: Callable, carry0, extras: Sequence = (),
                             per_iter_args: Optional[Callable] = None,
                             k_small: int = 2, k_large: int = 8,
                             reps: int = 5) -> Tuple[float, float]:
    """device_seconds_per_iter for self-chaining steps: ``step(carry,
    *extras[, x_i]) -> (carry, ...)``, each call fed the previous carry.
    ``per_iter_args(i)`` gives the i-th call's own input. Returns
    (seconds_per_iter, warm-up seconds)."""
    _require_cuda()
    state = {"carry": carry0}

    def run_k(k):
        for i in range(k):
            x = () if per_iter_args is None else (per_iter_args(i),)
            state["carry"] = step(state["carry"], *extras, *x)[0]

    t0 = time.perf_counter()
    run_k(2)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    return _differenced(run_k, k_small, k_large, reps), warm_s


def measure_link_s(reps: int = 15) -> float:
    """Median host seconds from launching an empty kernel on a resident
    scalar to seeing it finish: the fixed cost every host-timed call
    includes."""
    _require_cuda()
    x = torch.zeros((), device="cuda")
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x.add_(0.0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def cost_analysis_flops(fn: Callable, *args, **kwargs) -> Tuple[float, object]:
    """(floating-point operations, result) of one call ``fn(*args,
    **kwargs)``, counted by torch's per-operator formulas (convolutions,
    matrix products, attention; elementwise operations count 0). The call
    runs, side effects included. Works on any device."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Count(TorchDispatchMode):
        flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            return out

    with _Count() as counter:
        result = fn(*args, **kwargs)
    return float(counter.flops), result
