"""Architecture registry: ``--arch <id>`` resolution over the archs the
port trains (the GNN family and the two-tower recsys model).  The LM archs
(``configs.lm_archs``) serve but do not train on the port yet, so they
enter with their training slice."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchSpec


def _all() -> Dict[str, ArchSpec]:
    from repro_torch.configs.gnn_family import (EGNN, GAT_CORA, GATEDGCN,
                                                GRAPHCAST)
    from repro_torch.configs.recsys_family import TWO_TOWER
    specs = [EGNN, GRAPHCAST, GATEDGCN, GAT_CORA, TWO_TOWER]
    return {s.arch_id: s for s in specs}


def list_archs() -> List[str]:
    return list(_all().keys())


def get_arch(arch_id: str) -> ArchSpec:
    table = _all()
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{', '.join(table)}")
    return table[arch_id]
