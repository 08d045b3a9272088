"""Process groups in place of the JAX package's device mesh.

The JAX package runs its multi-device paths over a 1-D jax.sharding.Mesh on
the 'data' axis (qpgesture_tpu/parallel/mesh.py), with the reductions inside
shard_map. The port runs one process per rank under torch.distributed and
passes a ProcessGroup (None: the default group). A process that never
joined a group is a world of one, and every helper here then returns its
input as it is. The reductions map one to one:

  lax.pmin        all_reduce(MIN)
  lax.psum        all_reduce(SUM)
  lax.pmean       all_reduce(SUM) / world  (ReduceOp.AVG is NCCL's alone)
  lax.all_gather  all_gather, concatenated in rank order

Each rank holds its own device: cuda:{LOCAL_RANK} unless the caller names
one. NCCL refuses two ranks on one card, so ranks that share a card run
gloo, which moves CUDA tensors through host copies: the helpers make those
copies themselves, and gloo only ever sees CPU tensors. Nothing switches
backend or device on its own.
"""
from __future__ import annotations

import contextlib
import math
import os
import pickle
import tempfile
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if initialized() else 0


def is_main(group=None) -> bool:
    """Rank 0: the one rank that writes files and prints results."""
    return rank(group) == 0


def barrier(group=None) -> None:
    if world_size(group) > 1:
        dist.barrier(group)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device: Optional[DeviceLike] = None) -> torch.device:
    """This rank's device: the caller's, with a bare 'cuda' (or None) as
    cuda:{LOCAL_RANK}. Raises without a GPU unless the caller names the
    CPU."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return resolve_device(dev)


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def check_backend(backend: str, device: torch.device, world: int) -> None:
    """Refuse what NCCL cannot run: a rank on the CPU, or more ranks on this
    host than it has cards (NCCL stops at the first collective with
    "Duplicate GPU detected")."""
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError(f"NCCL runs on CUDA devices, not {device}; use "
                         "the gloo backend (--dist-backend gloo)")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count()
    if local_world > cards:
        raise ValueError(
            f"{local_world} ranks on this host share {cards} card(s), and "
            "NCCL refuses two ranks on one card; run ranks that share a "
            "card under the gloo backend (--dist-backend gloo) with the "
            "card named as their device")


def init_from_env(device: Optional[DeviceLike] = None,
                  backend: Optional[str] = None) -> torch.device:
    """Join the group that torch.distributed.run describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and
    return this rank's device. A process without that environment stays a
    world of one. backend None: nccl for a CUDA device, gloo for the CPU."""
    dev = rank_device(device)
    if "WORLD_SIZE" not in os.environ or initialized():
        return dev
    world = int(os.environ["WORLD_SIZE"])
    backend = backend or default_backend(dev)
    check_backend(backend, dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]))
    return dev


def shutdown() -> None:
    if initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def env_group(device: Optional[DeviceLike] = None,
              backend: Optional[str] = None) -> Iterator[torch.device]:
    """init_from_env for a command's lifetime: yields this rank's device;
    on the way out the ranks meet at a barrier (the others wait for rank 0's
    files) and the group that this call joined is left. A group the caller
    had already joined stays as it was."""
    joined = not initialized() and "WORLD_SIZE" in os.environ
    dev = init_from_env(device, backend)
    try:
        yield dev
        barrier()
    finally:
        if joined:
            shutdown()


def data_parallel_group(group=None, mesh_shape: Optional[Sequence[int]]
                        = None):
    """The group a data-parallel trainer reduces over: None in a world of
    one (the single-device path, where no collective runs), else the group
    (the default group for None). The data-parallel width is the group's
    world size, as the JAX trainers take every device of make_mesh(); a
    mesh_shape that says otherwise raises."""
    n = world_size(group)
    if mesh_shape is not None and math.prod(mesh_shape) != n:
        raise ValueError(
            f"mesh_shape={tuple(mesh_shape)} asks for "
            f"{math.prod(mesh_shape)} devices, but the process group has {n} "
            "rank(s): the data-parallel width is the group's world size")
    if n == 1:
        return None
    return dist.group.WORLD if group is None else group


def _collective_copy(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of t for a collective to write into: on the host
    when gloo would otherwise stage a CUDA tensor there itself."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.detach().cpu().contiguous()
    return t.detach().clone().contiguous()


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


def all_reduce(t: torch.Tensor, op: str = "sum",
               group=None) -> torch.Tensor:
    """all_reduce(op) of t over the group as a new tensor on t's device
    (t itself in a world of one). op: 'sum' or 'min'."""
    if world_size(group) == 1:
        return t
    x = _collective_copy(t, group)
    dist.all_reduce(x, op=_OPS[op], group=group)
    return x.to(t.device)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank src's t on every rank, as a new tensor on t's device (t itself
    in a world of one)."""
    if world_size(group) == 1:
        return t
    x = _collective_copy(t, group)
    dist.broadcast(x, src, group=group)
    return x.to(t.device)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's t concatenated along axis 0 in rank order."""
    n = world_size(group)
    if n == 1:
        return t
    x = _collective_copy(t, group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts).to(t.device)


def pmean(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Each tensor averaged over the group (lax.pmean): one all_reduce(SUM)
    of a flat buffer of them all, divided by the world size. The tensors
    share one dtype."""
    n = world_size(group)
    if n == 1:
        return list(tensors)
    flat = all_reduce(torch.cat([t.detach().reshape(-1) for t in tensors]),
                      "sum", group) / n
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) whose gradient is the all_reduce(SUM) of the
    gradients (the transpose of psum inside shard_map)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), "sum", ctx.group), None


def all_reduce_sum_autograd(x: torch.Tensor, group=None) -> torch.Tensor:
    return x if world_size(group) == 1 else _AllReduceSum.apply(x, group)


def local_block(x, group=None):
    """This rank's contiguous block of a batch's leading axis, the shard
    that P('data') gives a device. A batch that does not divide by the
    world size raises."""
    n = world_size(group)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not divide among "
                         f"{n} ranks")
    size = x.shape[0] // n
    r = rank(group)
    return x[r * size:(r + 1) * size]


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad axis to a device-count multiple; returns (padded, original_len)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad), n


def _spawned(r: int, fn: Callable, args: tuple, world: int, backend: str,
             tmp: str) -> None:
    os.environ.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                      LOCAL_WORLD_SIZE=str(world))
    if backend == "nccl":
        check_backend(backend, torch.device("cuda", r), world)
        torch.cuda.set_device(r)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            world_size=world, rank=r)
    try:
        result = fn(*args)
        path = os.path.join(tmp, f"rank{r}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (),
          backend: str = "gloo") -> list:
    """fn(*args) in ``world`` new processes joined in one group, rank i in
    process i (LOCAL_RANK i, so its default device is cuda:i; ranks that
    share a card take the card as an argument and run gloo). They meet
    through a file in a temporary directory, not a TCP port, so concurrent
    groups never collide. Returns the ranks' return values (picklable, on
    the host) in rank order; a rank that raises makes spawn raise."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_spawned, args=(fn, args, world, backend, tmp),
                           nprocs=world, join=True, start_method="spawn")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
