"""WCOJ motif features: the paper's engine inside the GNN data pipeline.

Per-vertex structural features (triangle count, diamond participation)
computed by BiGJoin and appended to node features — the §5.4
triangle-index idea resurfacing as feature engineering.  The join runs on
``device`` (the card unless the caller names another; see
``csr.resolve_device``), through the port's fused-extend kernel; the
counts are gathered on the host.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import csr
from repro_torch.core import query as Q
from repro_torch.core.bigjoin import (BigJoinConfig, build_indices,
                                      run_bigjoin, seed_tuples_for)
from repro_torch.core.csr import Graph
from repro_torch.core.plan import make_plan


def motif_counts(graph: Graph, motif: str = "triangle",
                 cfg: BigJoinConfig | None = None, device=None
                 ) -> np.ndarray:
    """[num_vertices] float32 count of motif instances per vertex."""
    device = csr.resolve_device(device)
    g = graph.degree_relabel()
    q = Q.query_by_name(motif, symmetric=motif in (
        "triangle", "4-clique", "5-clique"))
    plan = make_plan(q)
    rels = {Q.EDGE: g.edges}
    cfg = cfg or BigJoinConfig(batch=4096, seed_chunk=4096,
                               out_capacity=1 << 22)
    idx = build_indices(plan, rels, device=device)
    res = run_bigjoin(plan, idx, seed_tuples_for(plan, rels), cfg=cfg,
                      device=device)
    counts = np.zeros(graph.num_vertices, np.float32)
    if res.tuples is not None and res.tuples.size:
        np.add.at(counts, res.tuples.reshape(-1), 1.0)
    # relabeling is a bijection applied identically to features: invert it
    deg = np.zeros(graph.num_vertices, np.int64)
    np.add.at(deg, graph.edges[:, 0], 1)
    np.add.at(deg, graph.edges[:, 1], 1)
    order = np.lexsort((np.arange(graph.num_vertices), deg))
    inv = np.empty_like(counts)
    inv[order] = counts[np.arange(graph.num_vertices)]
    return inv


def motif_features(graph: Graph, motifs=("triangle",), device=None
                   ) -> np.ndarray:
    """[num_vertices, len(motifs)] log1p-scaled motif feature matrix."""
    cols = [np.log1p(motif_counts(graph, m, device=device)) for m in motifs]
    return np.stack(cols, axis=1).astype(np.float32)
