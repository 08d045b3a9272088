"""Device milliseconds of the operations launched inside the program's
``tables`` span (phase 1: the distance matrix by K1 or the cosine GEMM,
the per-code reduction and the ranks), per unit: the union of their
intervals (benchmark/spans.py). None where the run recorded no spans."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    row = spans and spans.get("tables")
    return row["device_ms"] if row and row["ops"] else None
