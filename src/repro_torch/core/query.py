"""Conjunctive (multiway equi-join) queries over relations.

The paper's setting (§2.1): a full conjunctive query

    Q(a_1,...,a_m) :- R_1(a_11,...,a_1r1), ..., R_n(a_n1,...,a_nrn)

For subgraph queries every atom is a replica of the binary ``edge`` relation
of the input graph; §5.4 additionally uses a ternary ``tri`` relation.

This module is pure metadata: atoms, attributes, the five paper queries,
symmetry-breaking filters, and delta-query generation (§3.3.1).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

EDGE = "edge"  # canonical name of the graph edge relation


@dataclasses.dataclass(frozen=True)
class Atom:
    """One relational atom R(attrs...). ``rel`` names the stored relation."""

    rel: str
    attrs: Tuple[int, ...]

    @property
    def arity(self) -> int:
        return len(self.attrs)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{self.rel}({','.join('a%d' % a for a in self.attrs)})"


@dataclasses.dataclass(frozen=True)
class Filter:
    """Inequality filter ``a_lo < a_hi`` (symmetry breaking, §5.4)."""

    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class Query:
    """A full conjunctive query over ``num_attrs`` attributes."""

    name: str
    num_attrs: int
    atoms: Tuple[Atom, ...]
    filters: Tuple[Filter, ...] = ()

    def __post_init__(self):
        for atom in self.atoms:
            for a in atom.attrs:
                if not (0 <= a < self.num_attrs):
                    raise ValueError(f"attribute a{a} out of range in {atom}")
            if len(set(atom.attrs)) != len(atom.attrs):
                raise ValueError(f"repeated attribute in atom {atom}")
        seen = set()
        for atom in self.atoms:
            seen.update(atom.attrs)
        if seen != set(range(self.num_attrs)):
            raise ValueError("every attribute must appear in some atom")

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    def attrs_of(self, rel: str) -> Sequence[Tuple[int, ...]]:
        return [a.attrs for a in self.atoms if a.rel == rel]


# ---------------------------------------------------------------------------
# The paper's five benchmark queries (§5, directed form).
# ---------------------------------------------------------------------------

def _clique(name: str, k: int, symmetric: bool = False) -> Query:
    atoms = tuple(
        Atom(EDGE, (i, j)) for i in range(k) for j in range(i + 1, k)
    )
    filt = tuple(Filter(i, i + 1) for i in range(k - 1)) if symmetric else ()
    return Query(name, k, atoms, filt)


def triangle(symmetric: bool = False) -> Query:
    """tri(a1,a2,a3) :- e(a1,a2), e(a2,a3), e(a1,a3).

    The paper's §5 triangle uses e(a1,a2),e(a1,a3),e(a2,a3); with
    ``symmetric`` the a1<a2<a3 symmetry-breaking filters are added
    (valid on degree-ordered / DAG-ified graphs).
    """
    return _clique("triangle", 3, symmetric)


def four_clique(symmetric: bool = False) -> Query:
    return _clique("4-clique", 4, symmetric)


def five_clique(symmetric: bool = False) -> Query:
    return _clique("5-clique", 5, symmetric)


def diamond() -> Query:
    """diamond :- e(a1,a2), e(a2,a3), e(a4,a1), e(a4,a3)."""
    return Query(
        "diamond",
        4,
        (
            Atom(EDGE, (0, 1)),
            Atom(EDGE, (1, 2)),
            Atom(EDGE, (3, 0)),
            Atom(EDGE, (3, 2)),
        ),
    )


def house(symmetric: bool = False) -> Query:
    """SEED q6 (§5): 5-clique minus edges (a1,a4),(a1,a5)."""
    atoms = (
        Atom(EDGE, (0, 1)),
        Atom(EDGE, (0, 2)),
        Atom(EDGE, (1, 2)),
        Atom(EDGE, (1, 3)),
        Atom(EDGE, (2, 3)),
        Atom(EDGE, (1, 4)),
        Atom(EDGE, (2, 4)),
        Atom(EDGE, (3, 4)),
    )
    # symmetry of the (a2,a3) pair and of the (a4,a5) pair
    filt = (Filter(1, 2), Filter(3, 4)) if symmetric else ()
    return Query("house", 5, atoms, filt)


def four_clique_tri() -> Query:
    """4-clique rewritten over the ternary ``tri`` relation (§5.4):

        4clq :- tri(a1,a2,a3), tri(a1,a2,a4), tri(a1,a3,a4)
    """
    return Query(
        "4-clique-tri",
        4,
        (
            Atom("tri", (0, 1, 2)),
            Atom("tri", (0, 1, 3)),
            Atom("tri", (0, 2, 3)),
        ),
    )


def path(length: int) -> Query:
    """Open path a1 -> a2 -> ... (the classic edge-at-a-time blowup case)."""
    atoms = tuple(Atom(EDGE, (i, i + 1)) for i in range(length))
    return Query(f"path-{length}", length + 1, atoms)


PAPER_QUERIES = {
    "triangle": triangle,
    "4-clique": four_clique,
    "5-clique": five_clique,
    "diamond": diamond,
    "house": house,
    "4-clique-tri": four_clique_tri,
}

# ---------------------------------------------------------------------------
# Named-query registry: the ONE query-name -> builder mapping shared by every
# driver and the facade (repro_torch.api).
# ---------------------------------------------------------------------------

# builders that accept the ``symmetric`` keyword (symmetry-breaking filters)
_SYMMETRIC_OK = frozenset({"triangle", "4-clique", "5-clique", "house"})

# alternate spellings accepted by query_by_name (normalized form -> canonical)
_ALIASES = {
    "tri": "triangle",
    "four-clique": "4-clique",
    "five-clique": "5-clique",
    "4clique": "4-clique",
    "5clique": "5-clique",
    "four-clique-tri": "4-clique-tri",
}

QUERY_REGISTRY = dict(PAPER_QUERIES)
QUERY_NAMES = tuple(QUERY_REGISTRY)


def query_by_name(name: str, symmetric: bool = False) -> Query:
    """Build a named query: the paper's five benchmark motifs plus
    ``path-N``.  Accepts underscore/case variants (``four_clique``) and
    threads ``symmetric`` only to the builders that support it."""
    norm = name.strip().lower().replace("_", "-")
    norm = _ALIASES.get(norm, norm)
    if norm.startswith("path-"):
        if symmetric:
            raise ValueError(f"query {norm!r} has no symmetric variant")
        try:
            return path(int(norm[len("path-"):]))
        except ValueError:
            raise KeyError(f"bad path length in query name {name!r}")
    if norm not in QUERY_REGISTRY:
        raise KeyError(
            f"unknown query {name!r}; known: {', '.join(QUERY_NAMES)} "
            "or path-N")
    build = QUERY_REGISTRY[norm]
    if symmetric and norm not in _SYMMETRIC_OK:
        raise ValueError(f"query {norm!r} has no symmetric variant")
    return build(symmetric=symmetric) if norm in _SYMMETRIC_OK else build()


# ---------------------------------------------------------------------------
# Delta queries (§3.3.1).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeltaQuery:
    """dQ_i :- R'_1,...,R'_{i-1}, dR_i, R_{i+1},...,R_n.

    ``versions[k]`` gives the version of atom k: "new" for k<i, "delta" for
    k==i, "old" for k>i.  ``seed_atom`` is i.  The attribute order for dQ_i
    must begin with atom i's attributes (Thm 3.2) — enforced by the planner.
    """

    query: Query
    seed_atom: int

    @property
    def versions(self) -> Tuple[str, ...]:
        i = self.seed_atom
        return tuple(
            "new" if k < i else ("delta" if k == i else "old")
            for k in range(self.query.num_atoms)
        )


def delta_queries(q: Query) -> Tuple[DeltaQuery, ...]:
    return tuple(DeltaQuery(q, i) for i in range(q.num_atoms))


# ---------------------------------------------------------------------------
# AGM bound (fractional edge cover) — used by tests and the roofline of the
# paper's own workload.  For the common case of subgraph queries over a
# single edge relation with |E| = IN, MaxOut_Q = IN^{rho*}.
# ---------------------------------------------------------------------------

def fractional_edge_cover(q: Query) -> float:
    """Solve the fractional edge cover LP by brute force over vertices of the
    LP polytope for small queries (n_atoms <= 10) via scipy-free simplex on a
    grid refinement; falls back to known closed forms for cliques."""
    # Known closed forms: k-clique rho* = k/2.
    import itertools

    import numpy as np

    n, m = q.num_atoms, q.num_attrs
    # Solve min 1.x  s.t. A x >= 1, x >= 0 where A[j,i] = attr j in atom i.
    A = np.zeros((m, n))
    for i, atom in enumerate(q.atoms):
        for a in atom.attrs:
            A[a, i] = 1.0
    # Vertices of {A x >= 1, x >= 0} arise from choosing n tight constraints
    # among the m + n available; enumerate (fine for paper-sized queries).
    rows = [(A[j], 1.0) for j in range(m)] + [
        (np.eye(n)[i], 0.0) for i in range(n)
    ]
    best = float("inf")
    for combo in itertools.combinations(range(len(rows)), n):
        M = np.stack([rows[c][0] for c in combo])
        b = np.array([rows[c][1] for c in combo])
        try:
            x = np.linalg.solve(M, b)
        except np.linalg.LinAlgError:
            continue
        if (x >= -1e-9).all() and (A @ x >= 1.0 - 1e-9).all():
            best = min(best, float(x.sum()))
    return best


def agm_bound(q: Query, num_edges: int) -> float:
    """MaxOut_Q = IN^{rho*} when every relation has size IN (§1.1)."""
    return float(num_edges) ** fractional_edge_cover(q)
