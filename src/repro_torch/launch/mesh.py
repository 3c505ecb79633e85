"""The worker mesh of the distributed dataflow, on one card.

NCCL does not put two ranks on one GPU, so the w workers of the paper's
cluster are a leading ``[w]`` axis of every tensor of one process, on one
device (``core.distributed``): the exchanges between them are local
transposes and reductions.  A :class:`WorkerMesh` names that worker count
and the device.  The JAX package's ``make_production_mesh`` (the dry-run's
512-device TPU mesh) and its TPU roofline constants are not carried over:
the mesh of the dry-run comes with its port.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.csr import resolve_device

# Workers of a mesh no one sized: the port's stand-in for the JAX
# package's device count, whose tests and drivers force four host devices
# (``--xla_force_host_platform_device_count=4``).
DEFAULT_WORKERS = 4


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
