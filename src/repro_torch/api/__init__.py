"""repro_torch.api — the public facade of the port::

    from repro_torch.api import GraphSession

    session = GraphSession(initial_edges)            # owns the graph
    tri = session.register("triangle")               # named motif
    res = session.update(edge_batch, weights)        # ONE commit per epoch
    print(res.deltas["triangle"].count_delta)        # per-query signed delta
"""
from repro_torch.api.dsl import PatternSyntaxError, parse_pattern, pattern_of
from repro_torch.api.session import (EpochResult, GraphSession, QueryHandle,
                                     Sizing, auto_sizing)
from repro_torch.core.capacity import Ratchet
from repro_torch.core.csr import pow2_capacity
from repro_torch.core.delta import canon_signed
from repro_torch.core.query import (PAPER_QUERIES, QUERY_NAMES,
                                    QUERY_REGISTRY, Query, agm_bound,
                                    query_by_name)

__all__ = [
    "GraphSession", "QueryHandle", "EpochResult", "Sizing", "auto_sizing",
    "parse_pattern", "pattern_of", "PatternSyntaxError",
    "Query", "query_by_name", "QUERY_NAMES", "QUERY_REGISTRY",
    "PAPER_QUERIES", "agm_bound", "canon_signed", "pow2_capacity", "Ratchet",
]
