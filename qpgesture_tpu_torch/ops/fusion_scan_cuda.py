"""CUDA kernel for the matching engine's fusion scan (phase 2).

Replaces no TPU kernel: the JAX package runs the scan as a ``lax.scan``
(``qpgesture_tpu/match/engine.py :: _fuse_scan``). Its plain version is the
host loop ``match/engine.py :: _scan_loop``, one iteration a step, which the
engine runs for CPU tensors. The kernel source is ``csrc/fusion_scan.cu``
(its header says what bounds it on an H100 and what the design does about
it): every step of every lane in one launch, bit for bit the loop's blocks,
phases and votes. It is compiled with ``nvcc`` for ``sm_90a`` on first use
(``ops/cuda_build.py``) and bound with ctypes.

``fusion_scan`` is the wrapper. It takes CUDA tensors only: it launches the
kernel or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Union

import torch

from . import cuda_build

SOURCE = "fusion_scan.cu"

launches = 0
_lib = None


class Grid(NamedTuple):
    """A side's candidate (head, tail) pairs read from its pair grid."""
    ht: torch.Tensor    # (rows, 2, 8, 16) float32
    pos: torch.Tensor   # (Q, P) int64 grid row of each candidate


class Sliced(NamedTuple):
    """A side's candidate pairs sliced from the database's phase / amp:
    frames clamp(start, 0, T - 32) + 0..7 and + 24..31 of sequence seq."""
    phase: torch.Tensor  # (J, T, 8) float32
    amp: torch.Tensor    # (J, T, 8) float32
    seq: torch.Tensor    # (Q, P) int64
    start: torch.Tensor  # (Q, P) int64


Pairs = Union[Grid, Sliced]


def build() -> str:
    """Compile the kernel library unless this source was built already;
    returns the path of the shared library."""
    return cuda_build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.qpg_fusion_scan_cuda
        fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p] * 20
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _expect(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple):
    """Raise unless t has dtype and shape (None in shape: any extent)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")


def fusion_scan(lanes: int, n_steps: int, seed_off: int,
                sel_a: torch.Tensor, sel_b: Optional[torch.Tensor],
                blocks: Sequence[torch.Tensor],
                pairs: Optional[Sequence[Pairs]], mask: torch.Tensor,
                reset_code: Optional[torch.Tensor],
                reset_phase: Optional[torch.Tensor],
                rand_bits: Optional[torch.Tensor]):
    """The fusion scan of ``lanes`` lanes of L = Q / lanes steps each, one
    block a lane (the mode follows from the inputs, as the engine's flags):

      blocks       (Q, P, S) int64 continuation codes: one side's, or the
                   audio and the text side's
      pairs        None (no phase), or one Grid / Sliced for each block
      sel_a        (Q, P) int64 selection, or (Q, P, 2), the top-2 order,
                   with one side and pairs
      sel_b        (Q, P) int64, the text side's, with two sides and pairs;
                   else None
      mask         (L,) int32, nonzero at the steps where every lane resets
      reset_code   (Q,) int64 and reset_phase (Q, 8, 16) float32, the
                   carries at those steps; both None when no step resets.
                   Codes lie in [0, P): the kernel indexes with them
                   unchecked (the engine checks the codes it is given)
      rand_bits    (Q,) int32, nonzero where a step takes the audio side:
                   with two sides and no pairs; else None

    Every lane starts from code 0 and a zero phase unless its step 0 resets;
    a window's last step (t % n_steps == n_steps - 1) seeds the next from
    its block[seed_off]. Returns (blocks (Q, S) int64, phases (Q, 8, 16)
    float32, votes (Q,) int32), computed on the card."""
    global launches
    both = len(blocks) == 2
    if len(blocks) not in (1, 2):
        raise ValueError(f"expected one or two sides' blocks, got "
                         f"{len(blocks)}")
    _expect("blocks[0]", blocks[0], torch.int64, (None, None, None))
    Q, P, S = blocks[0].shape
    for i, b in enumerate(blocks[1:], 1):
        _expect(f"blocks[{i}]", b, torch.int64, (Q, P, S))
    if lanes < 1 or Q % lanes:
        raise ValueError(f"{Q} steps do not split into {lanes} lanes")
    L = Q // lanes
    if not 0 <= seed_off < S or n_steps < 1 or not 0 < S <= 128:
        raise ValueError(f"seed_off {seed_off}, n_steps {n_steps} or step "
                         f"size {S} out of range")
    inputs = [sel_a, mask, *blocks]
    if pairs is None:
        mode = 1 if both else 0
        _expect("sel_a", sel_a, torch.int64, (Q, P))
        if sel_b is not None:
            raise ValueError("sel_b is read with pairs only")
        if both:
            if rand_bits is None:
                raise ValueError("two sides without pairs need rand_bits")
            _expect("rand_bits", rand_bits, torch.int32, (Q,))
            inputs.append(rand_bits)
        elif rand_bits is not None:
            raise ValueError("rand_bits are read with two sides and no "
                             "pairs only")
    else:
        mode = 3 if both else 2
        if len(pairs) != len(blocks):
            raise ValueError(f"{len(pairs)} pair sources for "
                             f"{len(blocks)} sides")
        if rand_bits is not None:
            raise ValueError("rand_bits are read without pairs only")
        if both:
            _expect("sel_a", sel_a, torch.int64, (Q, P))
            if sel_b is None:
                raise ValueError("two sides with pairs need sel_b")
            _expect("sel_b", sel_b, torch.int64, (Q, P))
            inputs.append(sel_b)
        else:
            _expect("sel_a", sel_a, torch.int64, (Q, P, 2))
            if sel_b is not None:
                raise ValueError("sel_b is read with two sides only")
        kinds = {type(src) for src in pairs}
        if len(kinds) != 1 or not kinds <= {Grid, Sliced}:
            raise ValueError("pairs: every side a Grid, or every side "
                             "Sliced")
        for i, src in enumerate(pairs):
            if isinstance(src, Grid):
                _expect(f"pairs[{i}].ht", src.ht, torch.float32,
                        (None, 2, 8, 16))
                _expect(f"pairs[{i}].pos", src.pos, torch.int64, (Q, P))
            else:
                _expect(f"pairs[{i}].phase", src.phase, torch.float32,
                        (None, None, 8))
                _expect(f"pairs[{i}].amp", src.amp, torch.float32,
                        tuple(src.phase.shape))
                _expect(f"pairs[{i}].seq", src.seq, torch.int64, (Q, P))
                _expect(f"pairs[{i}].start", src.start, torch.int64, (Q, P))
                if src.phase.shape[1] < 32:
                    raise ValueError(f"pairs[{i}]: {src.phase.shape[1]} "
                                     f"frames, fewer than a 32-frame window")
                if src.phase is not pairs[0].phase or \
                        src.amp is not pairs[0].amp:
                    raise ValueError("sliced sides must share phase / amp")
            inputs.extend(src)
    _expect("mask", mask, torch.int32, (L,))
    if (reset_code is None) != (reset_phase is None):
        raise ValueError("reset_code and reset_phase come together")
    if reset_code is not None:
        _expect("reset_code", reset_code, torch.int64, (Q,))
        _expect("reset_phase", reset_phase, torch.float32, (Q, 8, 16))
        inputs += [reset_code, reset_phase]

    device = sel_a.device
    if device.type != "cuda":
        raise ValueError(f"the fusion scan kernel runs on a CUDA device, "
                         f"not {device}; the engine's plain loop "
                         f"(match/engine.py _scan_loop) is the CPU path")
    if any(t.device != device for t in inputs):
        raise ValueError("inputs on different devices: "
                         f"{sorted({str(t.device) for t in inputs})}")
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in inputs if t.dtype == torch.float32):
        raise ValueError("float32 inputs must be 16-byte aligned")
    T = pairs[0].phase.shape[1] if pairs and isinstance(pairs[0], Sliced) \
        else 0
    if max(Q, P, T) >= 2 ** 31:
        raise ValueError(f"Q={Q}, P={P}, T={T} exceed the kernel's int32 "
                         f"extents")

    out_block = torch.empty((Q, S), dtype=torch.int64, device=device)
    out_phase = torch.empty((Q, 8, 16), dtype=torch.float32, device=device)
    out_vote = torch.empty((Q,), dtype=torch.int32, device=device)
    if Q == 0:
        return out_block, out_phase, out_vote
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def side(i):
        """(ht, idx0, idx1) pointers of side i."""
        if pairs is None or i >= len(pairs):
            return None, None, None
        src = pairs[i]
        if isinstance(src, Grid):
            return ptr(src.ht), ptr(src.pos), None
        return None, ptr(src.seq), ptr(src.start)

    grid = pairs is not None and isinstance(pairs[0], Grid)
    sliced = pairs[0] if pairs is not None and not grid else None
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.qpg_fusion_scan_cuda(
            mode, int(grid), lanes, L, P, S, n_steps, seed_off, T,
            ptr(sel_a), ptr(sel_b), ptr(blocks[0]),
            ptr(blocks[1]) if both else None, *side(0), *side(1),
            ptr(sliced.phase) if sliced else None,
            ptr(sliced.amp) if sliced else None, ptr(mask), ptr(rand_bits),
            ptr(reset_code), ptr(reset_phase), ptr(out_block),
            ptr(out_phase), ptr(out_vote), stream)
    if err != 0:
        raise RuntimeError(f"fusion scan kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out_block, out_phase, out_vote

