"""repro_torch.api — the public facade of the port::

    from repro_torch.api import GraphSession

    session = GraphSession(initial_edges)            # owns the graph
    tri = session.register("triangle")               # named motif
    res = session.update(edge_batch, weights)        # ONE commit per epoch
    print(res.deltas["triangle"].count_delta)        # per-query signed delta
    leaves, meta = session.snapshot()                # the JAX format
"""
from repro_torch.api.dsl import PatternSyntaxError, parse_pattern, pattern_of
from repro_torch.api.session import (EpochResult, GraphSession, QueryHandle,
                                     Sizing, auto_sizing)
from repro_torch.core import compilestats
from repro_torch.core.capacity import Ratchet
from repro_torch.core.csr import Graph, pow2_capacity
from repro_torch.core.delta import canon_signed
from repro_torch.core.query import (PAPER_QUERIES, QUERY_NAMES,
                                    QUERY_REGISTRY, Query, agm_bound,
                                    query_by_name)

__all__ = [
    "GraphSession", "QueryHandle", "EpochResult", "Sizing", "auto_sizing",
    "parse_pattern", "pattern_of", "PatternSyntaxError",
    "Query", "query_by_name", "QUERY_NAMES", "QUERY_REGISTRY",
    "PAPER_QUERIES", "agm_bound", "Graph", "oracle_count", "canon_signed",
    "pow2_capacity", "Ratchet", "compilestats",
]


def oracle_count(query, edges) -> int:
    """Serial Generic-Join ground truth over an edge array — or a full
    relations dict ``{"edge": ..., "tri": ...}`` for multi-relation queries
    (the COST-style single-core baseline) — on the host, for verification
    in examples and drivers without reaching into ``repro_torch.core``."""
    from repro_torch.core.generic_join import generic_join
    from repro_torch.core.query import EDGE
    if isinstance(query, str):
        query = query_by_name(query) if ":=" not in query \
            else parse_pattern(query)
    relations = edges if isinstance(edges, dict) else {EDGE: edges}
    _, cnt = generic_join(query, relations, enumerate_results=False)
    return int(cnt)
