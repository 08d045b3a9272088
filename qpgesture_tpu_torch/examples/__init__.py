"""Drivers of the port's API, one module per script of the JAX package's
``examples/``, under the same names:

    python -m qpgesture_tpu_torch.examples.<name> [the script's arguments]

Each runs on the card unless given ``--device cpu``. Their work sits in
plain functions that take ``device``, for the tests and ``chip_smoke.py``
to call; nothing runs at import.
"""
