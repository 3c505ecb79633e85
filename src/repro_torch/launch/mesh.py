"""The worker mesh of the distributed dataflow, on one card.

NCCL does not put two ranks on one GPU, so the w workers of the paper's
cluster are a leading ``[w]`` axis of every tensor of one process, on one
device (``core.distributed``): the exchanges between them are local
transposes and reductions.  A :class:`WorkerMesh` names that worker count
and the device.

:func:`make_production_mesh` is the dry run's mesh (``launch.dryrun``):
the JAX package's axis names and sizes as a mapping of name to size, read
as 256 or 512 H100s.  No device stands behind it; ``distributed.sharding``
turns it into each device's shard shapes.  The roofline constants below
are the H100's, one source for the dry run and ``chip_smoke.py``'s kernel
bounds (the JAX package's TPU v5e constants are not carried over).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.csr import resolve_device

# Workers of a mesh no one sized: the port's stand-in for the JAX
# package's device count, whose tests and drivers force four host devices
# (``--xla_force_host_platform_device_count=4``).
DEFAULT_WORKERS = 4

# NVIDIA H100 80GB HBM3 (SXM part, 700 W): data-sheet peaks, dense rates
HBM_BYTES_PER_S = 3.35e12  # device memory
SCALAR_OPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # bf16 on the tensor cores


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """``num_workers`` workers of the dataflow on ``device`` (a string:
    the mesh is hashable, like the JAX package's)."""

    num_workers: int
    device: str

    def __post_init__(self):
        if int(self.num_workers) < 1:
            raise ValueError(f"a mesh has at least one worker, got "
                             f"{self.num_workers}")


def make_host_mesh(num_workers: int, device=None) -> WorkerMesh:
    """A mesh of ``num_workers`` workers on ``device`` (``None``: the card,
    see ``csr.resolve_device``)."""
    return WorkerMesh(int(num_workers), str(resolve_device(device)))


def make_production_mesh(multi_pod: bool = False) -> Dict[str, int]:
    """The (data 16, model 16) single-pod or (pod 2, data 16, model 16)
    two-pod production mesh, axis name -> size."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}
