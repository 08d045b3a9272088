"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default and raises when no GPU
is present; the caller asks for the CPU explicitly (``device="cpu"``), as
the tests do. Nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def to_device(x, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array (or a tensor) as a tensor on `device`. A copy to a card
    is queued on the current stream (non_blocking): the host does not wait
    for the card, so serving loops that must not synchronise can upload
    their inputs. On the CPU a numpy input may be shared, not copied."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.to(device, non_blocking=True)


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


@contextlib.contextmanager
def cudnn_autotune() -> Iterator[None]:
    """Let cuDNN time its candidate algorithms the first time it meets a
    convolution shape and keep the fastest (``torch.backends.cudnn.
    benchmark``), inside the block only. The trainers' steps run under it:
    without it, cuDNN's heuristic takes FFT-tiled kernels for the VQ-VAE's
    dilated-conv backward passes, about five times slower than the
    implicit-GEMM kernels the timing finds and with ~15 times the memory
    (batch 256 on an H100). TF32 stays off either way."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev
