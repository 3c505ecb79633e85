"""Config system: every architecture is an ArchSpec with
  * the exact assigned full config (dry-run only: on ``meta`` tensors,
    never allocated)
  * a reduced smoke config (one real train step in tests)
  * its input-shape set, each a :class:`Cell` that builds the step and
    its arguments for ``launch.dryrun``
  * ``smoke_run`` (a few real steps of a config) and ``model_flops``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (architecture x input-shape) dry-run cell."""

    shape_name: str
    kind: str  # train | prefill | decode | serve | retrieval | join | delta
    # build(mesh) -> (step, args, logical axes (a tree like args),
    # donated argument positions).  ``mesh`` maps axis name to size
    # (``launch.mesh.make_production_mesh``); the arguments are ``meta``
    # tensors, modules on ``meta``, and plain ints (counted as the int32
    # scalars the JAX programs carry); ``step(*args)`` runs on them.
    build: Callable[[Mapping[str, int]],
                    Tuple[Callable, Tuple, Any, Tuple[int, ...]]]
    skip_reason: Optional[str] = None
    # depth probing: probe(mesh, depth) builds the same cell at a reduced
    # layer depth; the dry run counts two depths and extrapolates to
    # ``full_depth``
    probe: Optional[Callable] = None
    probe_depths: Tuple[int, int] = (1, 2)
    full_depth: int = 0
    probe_scale: float = 1.0  # full-cell cost / probe cost (batch ratio)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | wcoj
    describe: str
    full_config: Any
    smoke_config: Any
    cells: Dict[str, Cell]
    # smoke_run(cfg, device=None) -> metrics dict; real reduced-config
    # steps
    smoke_run: Callable[..., Dict[str, float]]
    model_flops: Callable[[str], float]  # analytic 6*N*D-style FLOPs/step
