"""Architecture registry: ``--arch <id>`` resolution over the JAX
package's archs: the five LM archs, the GNN family, the two-tower recsys
model and ``wcoj-subgraph``, the paper's own workload."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchSpec


def _all() -> Dict[str, ArchSpec]:
    from repro_torch.configs import lm_archs as lm
    from repro_torch.configs.gnn_family import (EGNN, GAT_CORA, GATEDGCN,
                                                GRAPHCAST)
    from repro_torch.configs.recsys_family import TWO_TOWER
    from repro_torch.configs.wcoj import WCOJ
    specs = [lm.LLAMA4_SCOUT, lm.MIXTRAL_8X7B, lm.YI_34B, lm.GEMMA_7B,
             lm.GEMMA2_2B, EGNN, GRAPHCAST, GATEDGCN, GAT_CORA, TWO_TOWER,
             WCOJ]
    return {s.arch_id: s for s in specs}


def list_archs() -> List[str]:
    return list(_all().keys())


def get_arch(arch_id: str) -> ArchSpec:
    table = _all()
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{', '.join(table)}")
    return table[arch_id]
