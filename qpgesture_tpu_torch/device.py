"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default and raises when no GPU
is present; the caller asks for the CPU explicitly (``device="cpu"``), as
the tests do. Nothing falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """torch.device for `device`, with a bare 'cuda' pinned to the current
    card's index so that devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available()"
                " is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
