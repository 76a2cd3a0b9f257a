"""Process-group bootstrap and the ``(chains, data)`` mesh of ranks.

Counterpart of ``lda_thesis_tpu/parallel/bootstrap.py``, on
``torch.distributed``:

1. :func:`initialize_distributed` brings up the default process group from
   explicit arguments, else from the environment that ``python -m
   torch.distributed.run`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
   ``WORLD_SIZE``, ``RANK``), else from the JAX package's
   (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``).  With
   nothing set it does nothing and the world is one rank.  The backend is
   an argument: ``nccl`` for a CUDA device and ``gloo`` for the CPU by
   default; several ranks on one card run ``gloo`` with CUDA tensors, and
   the caller asks for that.  The backend that ran is printed.
2. :class:`Mesh`: rank ``r`` is mesh cell ``(ci, di) = divmod(r, n_data)``
   and holds its own device.  Chains never talk while they sample; the
   ranks of one data row (one ``ci``) merge count deltas through
   ``all_reduce`` on the row's process group.  Every collective here is an
   ``all_reduce``, the one that ``gloo`` offers for CUDA tensors: a gather
   sums zero-padded blocks, which is exact.
3. :func:`chains_for` splits a total chain count into (mesh chains axis,
   chains per rank).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "initialize_distributed",
    "is_distributed",
    "world",
    "local_device",
    "make_global_mesh",
    "chains_for",
    "shutdown",
]


def world() -> Tuple[int, int]:
    """``(rank, world_size)`` of this process; ``(0, 1)`` without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_distributed() -> bool:
    """True once a process group of more than one rank is up."""
    return world()[1] > 1


# The device :func:`initialize_distributed` brought this rank up on.
_rank_device: Optional[torch.device] = None


def local_device(device=None) -> torch.device:
    """The device this rank computes on: ``device`` if it names an index;
    with no ``device``, the one :func:`initialize_distributed` brought this
    rank's group up on, else ``"cuda"``; a CUDA device with no index is card
    ``LOCAL_RANK`` modulo the visible cards, so several ranks on one card
    all take ``cuda:0``."""
    if device is None and _rank_device is not None and dist.is_initialized():
        return _rank_device
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    count = torch.cuda.device_count()
    if count == 0:
        return dev  # no card: the first CUDA tensor raises, nothing falls back
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % count)


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = 300.0,
) -> bool:
    """Bring up the default process group (idempotent); True if one is up.

    Each argument comes from the caller first, then from the environment
    (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``, then
    ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``).  With none
    of them set this is a no-op and the world stays one rank.  ``backend``
    defaults to ``nccl`` where ``device`` is CUDA and ``gloo`` on the CPU.
    """
    global _rank_device
    if dist.is_initialized():
        return True
    if init_method is None:
        if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            init_method = "env://"
        elif os.environ.get("COORDINATOR_ADDRESS"):
            init_method = f"tcp://{os.environ['COORDINATOR_ADDRESS']}"
    if world_size is None:
        world_size = _env_int("WORLD_SIZE", "NUM_PROCESSES")
    if rank is None:
        rank = _env_int("RANK", "PROCESS_ID")
    if init_method is None and world_size is None:
        return False
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, init_method=init_method,
        world_size=1 if world_size is None else int(world_size),
        rank=0 if rank is None else int(rank),
        timeout=datetime.timedelta(seconds=timeout_s))
    _rank_device = dev
    r, w = world()
    print(f"torch.distributed: {backend} backend, rank {r} of {w}, device {dev}",
          flush=True)
    return True


def shutdown() -> None:
    """Destroy the default process group if one is up."""
    global _rank_device
    _rank_device = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class Mesh:
    """A ``(chains, data)`` grid of ranks and this rank's place in it.

    ``shape`` is ``{"chains": C, "data": S}``; ``coords`` is ``(ci, di)``;
    ``device`` is this rank's device.  ``data_group`` is the process group
    of this rank's data row, ``None`` where the row is one rank.
    """

    def __init__(self, n_chains: int, n_data: int, device, rank: int = 0,
                 world_size: int = 1, data_group=None):
        self.shape: Dict[str, int] = {"chains": int(n_chains), "data": int(n_data)}
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.coords: Tuple[int, int] = divmod(self.rank, int(n_data))
        self.device = torch.device(device)
        self.data_group = data_group
        self.backend = dist.get_backend() if world_size > 1 and dist.is_initialized() else None

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")

    @property
    def single_device(self) -> bool:
        return self.world_size == 1

    def data_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over this rank's data row (JAX's ``psum`` over
        ``data``); a row of one rank leaves it as it is."""
        if self.shape["data"] > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.data_group)
        return t

    def data_extreme_(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """Elementwise ``"max"`` or ``"min"`` of ``t`` in place over the data row."""
        if self.shape["data"] > 1:
            red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.MIN
            dist.all_reduce(t, op=red, group=self.data_group)
        return t

    def world_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over every rank."""
        if self.world_size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def barrier(self) -> None:
        if self.world_size > 1:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index or 0])
            else:
                dist.barrier()


def make_global_mesh(n_chains: int = 1, n_data: Optional[int] = None,
                     device=None) -> Mesh:
    """``(chains, data)`` mesh over every rank of the process group (one rank
    without a group).  ``n_data`` defaults to ``world_size // n_chains``.
    Every rank must call it, in the same order as its other group
    creations."""
    rank, size = world()
    if n_data is None:
        if size % n_chains:
            raise ValueError(f"{size} ranks not divisible by chains={n_chains}")
        n_data = size // n_chains
    if n_chains * n_data != size:
        raise ValueError(f"mesh {n_chains}x{n_data} != {size} ranks")
    group = None
    if size > 1 and n_data > 1:
        if n_chains == 1:
            group = dist.group.WORLD
        else:
            for ci in range(n_chains):  # every rank creates every row's group
                g = dist.new_group(list(range(ci * n_data, (ci + 1) * n_data)))
                if ci == rank // n_data:
                    group = g
    return Mesh(n_chains, n_data, local_device(device), rank, size, group)


def chains_for(total_chains: int, mesh: Mesh) -> Tuple[int, int]:
    """Split a total chain count into (mesh chains axis, chains per rank)."""
    mesh_chains = mesh.shape["chains"]
    if total_chains % mesh_chains:
        raise ValueError(
            f"total chains {total_chains} not divisible by mesh chains axis "
            f"{mesh_chains}")
    return mesh_chains, total_chains // mesh_chains
