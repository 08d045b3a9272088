"""Kernel K5: one-group GroupNorm, its per-channel affine and the activation.

    y[b, c, t] = act((x[b, c, t] - mean_b) * rsqrt(var_b + eps) * w[c] + b[c])

with the mean and the biased variance of each window b over all its C T
elements, and act the exact erf GELU (``nn.GELU()``) or ReLU: vq-wav2vec's
``GroupNorm(1, C)`` and activation after each convolution, in one pass.

Replaces no TPU kernel: the JAX package normalises with ``jnp``
(``qpgesture_tpu/models/vq_wav2vec.py:77-79``). PyTorch's one-group moments
give each window one block, so a clip's 6 windows were reduced on 6 of
the card's 132 SMs; K5 splits each window into tiles (the kernel source,
``csrc/groupnorm1_act.cu``, says how), compiled with ``nvcc`` for
``sm_90a`` on first use (``ops/cuda_build.py``) and bound with ctypes.

``groupnorm1_act`` is the wrapper: for CPU tensors it runs the plain
version (``groupnorm1_act_plain``, which is bit for bit ``nn.GroupNorm(1,
C)`` followed by ``nn.GELU()`` / ``nn.ReLU()``); for CUDA tensors it
launches the kernel pair or raises. ``launches`` counts kernel launches,
two a call.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

SOURCE = "groupnorm1_act.cu"
ACTIVATIONS = {"gelu": 0, "relu": 1}     # the kernel's act argument
# The tiling: a block reduces at least MIN_CHUNK elements (a 16-float group
# for each of its 256 threads), a window has at most MAX_TILES partials
# (what each apply block merges), and the grid aims at BLOCKS_PER_SM blocks
# per SM, a few waves of the card.
MIN_CHUNK = 4096
MAX_TILES = 1024
BLOCKS_PER_SM = 16

launches = 0
_fn = None
_sms = {}


def build() -> str:
    """Compile the kernel library unless this source was built already;
    returns the path of the shared library."""
    return cuda_build.build(SOURCE)


def _load():
    global _fn
    if _fn is None:
        fn = ctypes.CDLL(build()).qpg_groupnorm1_act_cuda
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_inputs(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 activation: str) -> None:
    """Raise on shapes, types, layouts or devices the function does not
    take."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, T), got {tuple(x.shape)}")
    C = x.shape[1]
    if tuple(weight.shape) != (C,) or tuple(bias.shape) != (C,):
        raise ValueError(f"weight and bias must be ({C},), got "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    if any(t.dtype != torch.float32 for t in (x, weight, bias)):
        raise TypeError("x, weight and bias must be float32")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous: each window one row of "
                         "C T floats")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} is not one of "
                         f"{sorted(ACTIVATIONS)}")
    devices = {t.device for t in (x, weight, bias)}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{sorted(map(str, devices))}")


def groupnorm1_act_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float,
                         activation: str) -> torch.Tensor:
    """``F.group_norm(x, 1, weight, bias, eps)``, then the activation."""
    check_inputs(x, weight, bias, activation)
    y = F.group_norm(x, 1, weight, bias, eps)
    return F.gelu(y) if activation == "gelu" else F.relu(y)


def tiling(B: int, n: int, device: torch.device) -> tuple:
    """(tiles, chunk) of a window of n elements: chunks of a multiple of 4
    elements, at least MIN_CHUNK (n permitting), at most MAX_TILES a
    window, and B x tiles near BLOCKS_PER_SM blocks per SM."""
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    want = -(-BLOCKS_PER_SM * _sms[device] // B)
    tiles = max(1, min(want, -(-n // MIN_CHUNK), MAX_TILES))
    chunk = -(-n // tiles)
    chunk += -chunk % 4
    return -(-n // chunk), chunk


def groupnorm1_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float, activation: str) -> torch.Tensor:
    """act(GroupNorm(1, C)(x)) for x (B, C, T) float32, contiguous, with the
    affine weight and bias (C,); activation "gelu" (exact) or "relu".
    Returns a new (B, C, T) float32 tensor."""
    global launches
    check_inputs(x, weight, bias, activation)
    if x.device.type == "cpu":
        return groupnorm1_act_plain(x, weight, bias, eps, activation)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, C, T = x.shape
    n = C * T
    if B >= 2 ** 16 or n >= 2 ** 31:
        raise ValueError(f"B={B}, C T={n} exceed the kernel's grid")
    y = torch.empty_like(x)
    if B == 0 or n == 0:
        return y
    tiles, chunk = tiling(B, n, x.device)
    partials = torch.empty((B, tiles, 3), dtype=torch.float32,
                           device=x.device)
    w, b = weight.contiguous(), bias.contiguous()
    fn = _load()
    args = (x.data_ptr(), y.data_ptr(), partials.data_ptr(), w.data_ptr(),
            b.data_ptr(), B, n, T, tiles, chunk, float(eps),
            ACTIVATIONS[activation])
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"GroupNorm kernel launch failed (cudaError "
                           f"{err})")
    launches += 2
    return y
