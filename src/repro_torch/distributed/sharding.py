"""Logical-axis sharding rules: model dimensions are named once
(``models.transformer.logical_axes``: "embed", "vocab", "expert", ...)
and a :class:`ShardingRules` table maps each name to physical mesh axes
("pod", "data", "model"), the JAX package's MaxText-style indirection.

The port keeps the table and its shape-aware mapping as plain data: a
mesh is a mapping of axis name to size and a spec is a tuple, one entry
a dimension (``None``, an axis name, or a tuple of names where the rule
declares a tuple).  The JAX package's ``logical_sharding``,
``shard_params`` and ``sharding_tree`` build ``NamedSharding`` objects
and ``device_put`` onto a device mesh; the port's workers share one card,
so they are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

# default logical->physical table for the production meshes
DEFAULT_RULES: Dict[str, Optional[object]] = {
    "batch": ("pod", "data"),  # DP over pods x data axis
    "batch_dp3": ("pod", "data", "model"),  # ZeRO-3 cells: DP everywhere
    "seq": None,  # sequence kept unsharded by default (SP selectively)
    "seq_shard": "model",  # sequence parallelism for long-context cells
    "embed": "data",  # FSDP: weight embed-dim over the DP axis
    "mlp": "model",  # TP: hidden of MLPs
    "heads": "model",  # TP: attention heads
    "kv_heads": "model",
    "vocab": "model",  # TP: embedding/unembedding
    "expert": "model",  # EP: MoE experts
    "nodes": ("pod", "data"),  # GNN: node partition
    "edges": ("pod", "data"),  # GNN: edge partition
    "feat": None,
    "table_rows": "model",  # recsys: embedding tables row-sharded
    "candidates": ("pod", "data"),  # retrieval scoring partition
    "workers": ("pod", "data", "model"),  # WCOJ: every chip is a worker
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    table: Tuple[Tuple[str, Optional[object]], ...]

    @classmethod
    def default(cls, **overrides) -> "ShardingRules":
        t = dict(DEFAULT_RULES)
        t.update(overrides)
        return cls(tuple(sorted(t.items(), key=lambda kv: kv[0])))

    def physical(self, logical: Tuple[Optional[str], ...],
                 mesh: Mapping[str, int],
                 shape: Optional[Tuple[int, ...]] = None) -> tuple:
        """Logical -> physical spec over ``mesh`` (axis name -> size).  An
        axis serves one dimension at most; with ``shape``, an axis that
        does not divide its dimension (with the axes kept before it) is
        dropped, and the next dimension mapped to it may take it (8
        experts cannot shard over a 16-way axis; mixtral's mlp dim then
        gets it)."""
        sizes = dict(mesh)
        axes = []
        used = set()
        t = dict(self.table)
        for i, name in enumerate(logical):
            if name is None:
                axes.append(None)
                continue
            phys = t.get(name)
            cands = (phys if isinstance(phys, tuple)
                     else ((phys,) if phys else ()))
            kept, prod = [], 1
            for p in cands:
                if p not in sizes or p in used:
                    continue
                if shape is not None and shape[i] % (prod * sizes[p]) != 0:
                    continue
                kept.append(p)
                used.add(p)
                prod *= sizes[p]
            if not kept:
                axes.append(None)
            elif isinstance(phys, tuple):
                axes.append(tuple(kept))  # keep the declared tuple form
            else:
                axes.append(kept[0])
        return tuple(axes)
