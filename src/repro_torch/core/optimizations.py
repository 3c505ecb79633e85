"""§5.4 optimizations: symmetry breaking, triangle indexing, factorization.

Each is a *transformation of inputs or queries*, not a change to the
dataflow, so the engine accommodates the specializations of SEED/FAQ-style
systems (Table 5).  ``engine="bigjoin"`` runs the port's static BiGJoin on
``device`` (``None``: the card, see ``csr.resolve_device``);
``engine="oracle"`` and :func:`factorized_house_count` run the host
Generic Join.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core import query as Q
from repro_torch.core.csr import Graph
from repro_torch.core.generic_join import _NpIndex, generic_join
from repro_torch.core.plan import make_plan


def symmetry_break(graph: Graph) -> Graph:
    """Degree-order relabel + orient edges low->high (§5.4 'SYM').

    After this transform, an undirected k-clique appears exactly once as the
    directed clique with a1 < a2 < ... < ak, so the symmetric query variants
    (``Q.four_clique(symmetric=True)`` etc.) enumerate each instance once
    instead of k! times.
    """
    return graph.degree_relabel()


def _bigjoin(q: Q.Query, rels, cfg, device):
    from repro_torch.core.bigjoin import (BigJoinConfig, build_indices,
                                          run_bigjoin, seed_tuples_for)
    plan = make_plan(q)
    cfg = cfg or BigJoinConfig(batch=4096, seed_chunk=4096,
                               out_capacity=1 << 22)
    idx = build_indices(plan, rels, device=device)
    return run_bigjoin(plan, idx, seed_tuples_for(plan, rels), cfg=cfg)


def build_triangle_relation(graph: Graph, engine: str = "bigjoin",
                            cfg=None, device=None) -> np.ndarray:
    """Materialize tri(a1,a2,a3) with a1<a2<a3 on a DAG-ified graph ('TR').

    The ternary relation is then indexable like any other (§5.4: "we support
    general relational queries and can index general relations").
    """
    rels = {Q.EDGE: graph.edges}
    if engine == "bigjoin":
        return _bigjoin(Q.triangle(symmetric=True), rels, cfg,
                        device).tuples
    tri, _ = generic_join(Q.triangle(symmetric=True), rels)
    return tri


def four_clique_via_tri(graph: Graph, engine: str = "bigjoin",
                        cfg=None, device=None) -> Tuple[int, np.ndarray]:
    """4-clique counting through the tri relation (fewer prefixes explored)."""
    tri = build_triangle_relation(graph, engine, cfg, device)
    rels = {"tri": tri}
    q = Q.four_clique_tri()
    if engine == "bigjoin":
        res = _bigjoin(q, rels, cfg, device)
        return res.count, res.tuples
    out, cnt = generic_join(q, rels)
    return cnt, out


def factorized_house_count(graph: Graph) -> int:
    """The house query via factorization (§5.4, [45]).

    house = clique(a2,a3,a4,a5) + a1 adjacent to a2 and a3.  Since a1 does
    not constrain a4/a5, its bindings stay *unflattened*: the count is

        sum over 4-cliques (b,c,d,e) of |{a : e(a,b) and e(a,c)}|

    computed without materializing the Cartesian product.  Assumes a
    symmetry-broken (DAG-ified) graph; counts each undirected house with
    a2<a3 and a4<a5 orientation exactly as the filtered flat query does.
    """
    g = graph
    rels = {Q.EDGE: g.edges}
    cliques, _ = generic_join(Q.four_clique(symmetric=True), rels)
    if cliques.shape[0] == 0:
        return 0
    # On the DAG the atoms force a2<a3<a4<a5 and a1->a2, a1->a3: so per
    # sorted 4-clique the a1 bindings are the common *in*-neighbors of its
    # two smallest vertices — counted, never flattened.
    rev = _NpIndex(g.edges, (1,), 0)  # dst -> src (in-neighbours)
    total = 0
    for row in cliques:
        b, c = np.int64(row[0]), np.int64(row[1])
        sb, cb = rev.ranges(np.array([b]))
        sc, cc = rev.ranges(np.array([c]))
        nb = rev.val[sb[0]:sb[0] + cb[0]]
        nc = rev.val[sc[0]:sc[0] + cc[0]]
        total += int(np.intersect1d(nb, nc, assume_unique=True).shape[0])
    return total
