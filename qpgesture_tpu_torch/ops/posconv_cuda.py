"""Kernel K6: WavLM's positional convolution, its bias, GELU and the
residual, channels last.

    x[b, t, c] = feats[b, t, c] + gelu(bias[c] + sum_{j<k} sum_{i<C/G}
                 feats[b, t + j - k/2, g C/G + i] W[c, i, j]),  g = c // (C/G)

for 0 <= t < T, with frames outside [0, T) read as zero: WavLM's
``pos_conv`` (a grouped Conv1d of kernel k and padding k // 2, SamePad's
trim of an even kernel's extra frame, the exact erf GELU) and the residual
add after it, T frames in and T out (``models/wavlm.py``).

Replaces no TPU kernel: the JAX package leaves this convolution to XLA
(``qpgesture_tpu/models/wavlm.py:288-295``). On the card PyTorch's grouped
float32 conv1d went to cuDNN's ``implicit_convolve_sgemm``, 2-3 TFLOP/s on
WavLM-Large's 16 groups of 64 channels and 128 taps, between two
transposing copies and a separate GELU and add. K6 is bound by operations
(2 B T C (C/G) k FLOPs at the float32 FMA rate: 0.80 ms for 16 windows of
199 frames; its ~73 MB take 0.02 ms): the kernel source
(``csrc/posconv.cu``) says how its register tiles over a sliding input
window keep the FMA pipes fed. It is compiled with ``nvcc`` for ``sm_90a``
on first use (``ops/cuda_build.py``) and bound with ctypes.

The kernel reads the weights packed (``pack_weight``): (G, k, C/G in, C/G
out), out channels fastest. It is built for groups of 48 or 64 channels
and k a multiple of 8 (``check_shape``): WavLM Base and Base+ (768
channels in 16 groups) and Large (1024), all with k = 128. ``posconv`` is
the wrapper: for CPU tensors it runs the plain version (``posconv_plain``
on ``unpack_weight(packed)``, which is bit for bit the module's
``pos_conv`` and residual); for CUDA tensors it launches the kernel or
raises, for inference only. ``launches`` counts kernel launches, one a
call. WavLM's forward on the CPU calls ``posconv_plain`` on the module's
weight itself, so the packed copy is made only for the card.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

SOURCE = "posconv.cu"
GROUP_WIDTHS = (48, 64)     # the kernel's instantiations: C / G
TAP_STEP = 8                # k must be a multiple of it
# frame tiles: whole warps, from two (a one-warp block leaves an SM three
# warps, its shared memory full) to seven (two blocks an SM at k = 128)
TILE_STEP, MIN_TILE, MAX_TILE = 32, 64, 224
# as csrc/posconv.cu lays out a block's shared memory: at most MAX_SMEM
# bytes, its weight ring NSTAGE stages of TAP_STEP taps x IC channels
MAX_SMEM = 232448
NSTAGE, IC = 3, 4

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
        fn = ctypes.CDLL(build()).qpg_posconv_cuda
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pack_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """The (C, C/G, k) grouped conv weight in K6's layout: (G, k, C/G in,
    C/G out), contiguous; packed[g, j, i, o] = weight[g C/G + o, i, j]."""
    C, cg, k = weight.shape
    if C != groups * cg:
        raise ValueError(f"weight {tuple(weight.shape)} is not a grouped "
                         f"conv weight of {groups} groups")
    return weight.reshape(groups, cg, cg, k).permute(0, 3, 2, 1).contiguous()


def unpack_weight(packed: torch.Tensor) -> torch.Tensor:
    """pack_weight's inverse: the (C, C/G, k) conv weight, contiguous."""
    G, k, cg, _ = packed.shape
    return packed.permute(0, 3, 2, 1).reshape(G * cg, cg, k).contiguous()


def check_shape(cg: int, k: int) -> None:
    """Raise unless the kernel is built for groups of `cg` channels and
    kernel size `k`."""
    if cg not in GROUP_WIDTHS or k % TAP_STEP:
        raise ValueError(f"no kernel instantiation for groups of {cg} "
                         f"channels and kernel size {k} (built: groups of "
                         f"{GROUP_WIDTHS}, k a multiple of {TAP_STEP})")


def check_inputs(feats: torch.Tensor, packed: torch.Tensor,
                 bias: torch.Tensor) -> None:
    """Raise on shapes, types, layouts or devices the function does not
    take, and on autograd through the kernel (it has no backward)."""
    if feats.dim() != 3:
        raise ValueError(f"feats must be (B, T, C), got {tuple(feats.shape)}")
    if packed.dim() != 4 or packed.shape[2] != packed.shape[3]:
        raise ValueError(f"packed weight must be (G, k, C/G, C/G), got "
                         f"{tuple(packed.shape)}")
    C = feats.shape[2]
    G, _, cg, _ = packed.shape
    if G * cg != C:
        raise ValueError(f"{C} channels are not {G} groups of {cg}")
    if tuple(bias.shape) != (C,):
        raise ValueError(f"bias must be ({C},), got {tuple(bias.shape)}")
    if any(t.dtype != torch.float32 for t in (feats, packed, bias)):
        raise TypeError("feats, the packed weight and bias must be float32")
    if not (feats.is_contiguous() and packed.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("feats, the packed weight and bias must be "
                         "contiguous: feats channels last, rows of C floats")
    devices = {t.device for t in (feats, packed, bias)}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{sorted(map(str, devices))}")
    if feats.device.type != "cpu" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (feats, packed, bias)):
        raise RuntimeError("the positional conv kernel is inference only: "
                           "call it under torch.no_grad()")


def posconv_plain(feats: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, groups: int) -> torch.Tensor:
    """feats + GELU(the grouped conv, trimmed to T frames), channels last:
    what ``pos_conv`` (conv, SamePad, GELU) and the residual compute on
    (B, T, C) feats and the (C, C/G, k) weight."""
    k = weight.shape[-1]
    y = F.conv1d(feats.transpose(1, 2), weight, bias, padding=k // 2,
                 groups=groups)
    if k % 2 == 0:
        y = y[..., :-1]
    return feats + F.gelu(y).transpose(1, 2)


def block_smem(tile: int, cg: int, k: int) -> int:
    """Shared bytes of a block: its input window (tile + k frames of the
    group's channels) and the weight ring."""
    return 4 * (cg * (tile + k) + NSTAGE * TAP_STEP * IC * cg)


def frame_tile(B: int, T: int, G: int, cg: int, k: int, sms: int) -> int:
    """Frames a block computes: of the tiles from MIN_TILE to MAX_TILE that
    fit a block's shared memory, the one that gives the busiest SM the
    fewest rounds of its four schedulers, the larger on a tie (fewer halo
    frames and weight passes). The B G ceil(T / tile) blocks spread evenly
    over the SMs, and a block of w warps takes ceil(w / 4) rounds: its
    warps share the SM's four schedulers, whose FMA pipes set the pace."""
    best, best_cost = None, None
    for tile in range(MIN_TILE, MAX_TILE + 1, TILE_STEP):
        if block_smem(tile, cg, k) > MAX_SMEM:
            break
        blocks = B * G * -(-T // tile)
        warps = -(-(tile // 8) * (cg // 8) // 32)
        cost = -(-blocks // sms) * -(-warps // 4)
        if best is None or cost <= best_cost:
            best, best_cost = tile, cost
    if best is None:
        raise ValueError(f"kernel size {k} leaves no frame tile in "
                         f"{MAX_SMEM} B of shared memory")
    return best


def sm_count(device: torch.device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


def launch(feats: torch.Tensor, packed: torch.Tensor, bias: torch.Tensor,
           tile: int) -> torch.Tensor:
    """One K6 launch with `tile` frames a block (posconv picks it); the
    inputs as ``posconv`` takes them, on a CUDA device."""
    global launches
    check_inputs(feats, packed, bias)
    if feats.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not "
                         f"{feats.device}")
    B, T, C = feats.shape
    G, k, cg, _ = packed.shape
    check_shape(cg, k)
    if B >= 2 ** 16 or G >= 2 ** 16:
        raise ValueError(f"B={B}, G={G} exceed the kernel's grid")
    if any(t.data_ptr() % 16 for t in (feats, packed, bias)):
        raise ValueError("feats, the packed weight and bias must start on "
                         "16-byte boundaries")
    y = torch.empty_like(feats)
    if B == 0 or T == 0:
        return y
    fn = _load()
    with torch.cuda.device(feats.device):
        err = fn(feats.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), B, T, C, G, k, tile,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"positional conv kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return y


def posconv(feats: torch.Tensor, packed: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """feats + GELU(pos_conv(feats)) for feats (B, T, C) float32, channels
    last and contiguous, the weight packed by ``pack_weight`` (G, k, C/G,
    C/G) and the bias (C,). Returns a new (B, T, C) float32 tensor."""
    check_inputs(feats, packed, bias)
    if feats.device.type == "cpu":
        return posconv_plain(feats, unpack_weight(packed), bias,
                             packed.shape[0])
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    B, T, _ = feats.shape
    G, k, cg, _ = packed.shape
    tile = frame_tile(B, T, G, cg, k, sm_count(feats.device))
    return launch(feats, packed, bias, tile)
