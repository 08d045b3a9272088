"""Device milliseconds of the operations launched inside the program's
``stage`` span (the device staging of the encoder's output and the
context), per unit: the union of their intervals (benchmark/spans.py).
None where the run recorded no spans."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    row = spans and spans.get("stage")
    return row["device_ms"] if row and row["ops"] else None
