"""Device operations launched inside the program's ``scan`` span (phase 2:
the selection tabulation, then the host loop of one iteration per step),
per unit (benchmark/spans.py). None where the run recorded no spans."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    row = spans and spans.get("scan")
    return row["ops"] if row and row["ops"] else None
