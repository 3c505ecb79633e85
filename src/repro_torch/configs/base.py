"""Config system: every architecture is an ArchSpec with
  * the exact assigned full config
  * a reduced smoke config (one real train step in tests)
  * ``smoke_run`` (a few real steps of a config) and ``model_flops``.

The JAX package's abstract dry-run cells (``Cell``: lowering a step over
a fake device mesh) have no meaning on one card and are not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # gnn | recsys | lm (the families the port has)
    describe: str
    full_config: Any
    smoke_config: Any
    # smoke_run(cfg, device=None) -> metrics dict; real reduced-config
    # steps
    smoke_run: Callable[..., Dict[str, float]]
    model_flops: Callable[[str], float]  # analytic 6*N*D-style FLOPs/step
