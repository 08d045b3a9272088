"""Host milliseconds inside the program's ``scan`` span, per unit, in the
window run after the traced one with spans on and no profiler: the scan
is launched from a host loop, and CUPTI's cost on each launch would
inflate exactly what its time is meant to show (benchmark/spans.py).
None where the run recorded no spans."""


def read(ctx):
    window = getattr(ctx, "span_window", None)
    return window.get("scan") if window else None
