"""The worker mesh of the distributed dataflow: w workers over R processes.

A :class:`WorkerMesh` names the paper's w workers, the device that holds
them and the ``torch.distributed`` ranks they run on.  Each rank holds
``wl = w / R`` of the workers, workers ``rank·wl .. rank·wl + wl - 1``, as
the leading ``[wl]`` axis of every tensor of the dataflow
(``core.distributed``); the exchanges between workers are local
transposes and reductions inside a rank and collectives over the default
process group between ranks (``core.exchange``).  R = 1, the mesh
:func:`make_host_mesh` builds, is one process with no process group: all
w workers on one device, and no collective is called.

:func:`init_rank_mesh` joins a process group and returns the rank's mesh.
The backend is the caller's choice and is never swapped for another: gloo
on the host, or with every rank on the one card (NCCL puts at most one
rank on a GPU), or NCCL with one rank a card.

:func:`make_production_mesh` is the dry run's mesh (``launch.dryrun``):
the JAX package's axis names and sizes as a mapping of name to size, read
as 256 or 512 H100s.  No device stands behind it; ``distributed.sharding``
turns it into each device's shard shapes.  The roofline constants below
are the H100's, one source for the dry run and ``chip_smoke.py``'s kernel
bounds (the JAX package's TPU v5e constants are not carried over), and
:func:`link_seconds` turns a card's sent bytes into the dry run's
collective time.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.csr import resolve_device

# Workers of a mesh no one sized: the port's stand-in for the JAX
# package's device count, whose tests and drivers force four host devices
# (``--xla_force_host_platform_device_count=4``).
DEFAULT_WORKERS = 4

BACKENDS = ("gloo", "nccl")

# NVIDIA H100 80GB HBM3 (SXM part, 700 W): data-sheet peaks, dense rates
HBM_BYTES_PER_S = 3.35e12  # device memory
SCALAR_OPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # bf16 on the tensor cores
# the links of an H100 SXM card, a direction: fourth-generation NVLink,
# 900 GB/s both ways to the other cards of its 8-card node (NVIDIA H100
# Tensor Core GPU data sheet), and between nodes one 400 Gb/s NDR
# InfiniBand port a card (NVIDIA DGX H100 data sheet: eight ConnectX-7
# 400 Gb/s ports for eight cards)
NODE_CARDS = 8
NVLINK_BYTES_PER_S = 450e9
NDR_BYTES_PER_S = 50e9


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """``num_workers`` workers of the dataflow on ``device`` (a string:
    the mesh is hashable, like the JAX package's, and keys the program
    cache), held by rank ``rank`` of ``ranks`` processes of the default
    process group (``backend``; ``None`` for one process), whose
    collectives fail after ``timeout_s`` seconds (not part of the key)."""

    num_workers: int
    device: str
    ranks: int = 1
    rank: int = 0
    backend: Optional[str] = None
    timeout_s: float = dataclasses.field(default=120.0, compare=False)

    def __post_init__(self):
        if int(self.num_workers) < 1:
            raise ValueError(f"a mesh has at least one worker, got "
                             f"{self.num_workers}")
        if int(self.ranks) < 1 or not 0 <= int(self.rank) < int(self.ranks):
            raise ValueError(f"rank {self.rank} of {self.ranks} ranks")
        if self.num_workers % self.ranks:
            raise ValueError(f"{self.num_workers} workers do not split "
                             f"evenly over {self.ranks} ranks")
        if self.ranks > 1 and self.backend not in BACKENDS:
            raise ValueError(f"a mesh of {self.ranks} ranks needs a backend "
                             f"of {BACKENDS}, got {self.backend!r}")

    @property
    def local_workers(self) -> int:
        """wl: the workers this rank holds."""
        return self.num_workers // self.ranks

    @property
    def span(self) -> Tuple[int, int]:
        """[first, last + 1) of this rank's workers."""
        lo = self.rank * self.local_workers
        return lo, lo + self.local_workers


def make_host_mesh(num_workers: int, device=None) -> WorkerMesh:
    """A mesh of ``num_workers`` workers in this one process on ``device``
    (``None``: the card, see ``csr.resolve_device``)."""
    return WorkerMesh(int(num_workers), str(resolve_device(device)))


def init_rank_mesh(num_workers: int, backend: str, device=None, *,
                   rank: Optional[int] = None, ranks: Optional[int] = None,
                   init_method: Optional[str] = None,
                   timeout_s: float = 120) -> WorkerMesh:
    """Join the default process group and return this rank's mesh.

    ``rank``/``ranks`` default to ``torch.distributed.run``'s ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (its ``MASTER_ADDR`` and
    ``MASTER_PORT``); every collective of the group fails after
    ``timeout_s`` seconds, so a rank that waits for a peer that never
    comes raises instead of hanging.  ``num_workers`` must split evenly
    over the ranks.  Device: NCCL takes ``cuda:LOCAL_RANK`` and raises
    without that card; gloo takes ``device`` (``None``: the card)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    import torch.distributed as dist
    if (rank is None and "RANK" not in os.environ) or \
            (ranks is None and "WORLD_SIZE" not in os.environ):
        raise RuntimeError("no rank given and no RANK/WORLD_SIZE set: pass "
                           "rank= and ranks=, or run under python -m "
                           "torch.distributed.run")
    rank = int(os.environ["RANK"] if rank is None else rank)
    ranks = int(os.environ["WORLD_SIZE"] if ranks is None else ranks)
    if int(num_workers) % ranks:
        raise ValueError(f"{num_workers} workers do not split evenly over "
                         f"{ranks} ranks")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"NCCL runs on the cards, not on {device}")
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if local >= found:
            raise RuntimeError(
                f"NCCL puts one rank on a card: local rank {local} needs "
                f"card {local}, and this machine has {found}")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != ranks or dist.get_rank() != rank or \
                dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group is already rank {dist.get_rank()} of "
                f"{dist.get_world_size()} on {dist.get_backend()}, not rank "
                f"{rank} of {ranks} on {backend}")
    else:
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=ranks,
            timeout=datetime.timedelta(seconds=float(timeout_s)))
    return WorkerMesh(int(num_workers), str(dev), ranks, rank, backend,
                      float(timeout_s))


def close_rank_mesh() -> None:
    """Leave the default process group, if this process joined one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def link_seconds(sent_bytes: float, devices: int) -> float:
    """The least time one card of ``devices`` (8-card NVLink nodes joined
    by NDR InfiniBand) takes to send ``sent_bytes`` spread evenly over the
    other cards: its shares to the 7 cards of its node over NVLink and to
    the rest over its NDR port, at the same time."""
    peers = max(int(devices) - 1, 1)
    near = min(NODE_CARDS, int(devices)) - 1
    return max(sent_bytes * near / peers / NVLINK_BYTES_PER_S,
               sent_bytes * (peers - near) / peers / NDR_BYTES_PER_S)


def make_production_mesh(multi_pod: bool = False) -> Dict[str, int]:
    """The (data 16, model 16) single-pod or (pod 2, data 16, model 16)
    two-pod production mesh, axis name -> size."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}
