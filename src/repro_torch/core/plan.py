"""Query planning for the GJ / BiGJoin dataflow.

A plan fixes the global attribute order (§2.2) and, for every prefix-extension
level, the set of *binding* atoms: atoms that constrain the next attribute in
terms of already-bound attributes.  Each binding atom at each level is backed
by one :class:`~repro_torch.core.csr.PrefixIndex` built at index time.

Subgraph queries are seeded from P_2 = the tuples of one edge atom (§4.2)
rather than the empty prefix; remaining atoms over the first two attributes
become membership filters on the seed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.query import Atom, DeltaQuery, Filter, Query


@dataclasses.dataclass(frozen=True)
class Binding:
    """One atom constraining the extension of attribute ``ext_attr``.

    ``key_attrs`` are the atom's attributes already bound (in atom order),
    whose values form the lookup key into the atom's PrefixIndex.
    ``atom_idx`` identifies the atom (and hence its version in delta plans).
    ``index_id`` names the PrefixIndex serving this binding.
    """

    atom_idx: int
    rel: str
    key_attrs: Tuple[int, ...]
    ext_attr: int
    index_id: str
    is_last: bool  # True iff this level binds the atom's final free attribute


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """Extend prefixes over ``bound_attrs`` with ``ext_attr``."""

    ext_attr: int
    bound_attrs: Tuple[int, ...]  # global order restricted to j bound attrs
    bindings: Tuple[Binding, ...]
    filters: Tuple[Filter, ...]  # inequality filters decidable at this level


@dataclasses.dataclass(frozen=True)
class Plan:
    query: Query
    attr_order: Tuple[int, ...]
    seed_atom: int  # atom supplying the seed prefixes P_w
    seed_cols: Tuple[int, ...]  # positions of order[:seed_width] in the atom
    seed_filters: Tuple[Binding, ...]  # other atoms inside the seed prefix
    seed_ineq: Tuple[Filter, ...]
    levels: Tuple[LevelPlan, ...]  # extensions for order[seed_width:]
    versions: Tuple[str, ...]  # per-atom version ("static" unless delta plan)

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def seed_width(self) -> int:
        """Width of the seed prefixes: 2 for projection-seeded static plans
        (P_2, §4.2), the seed atom's arity for dR-seeded delta plans — an
        n-ary dR tuple binds ALL its attributes at once (§3.3/Thm 3.2), so
        the dataflow starts at P_r and level li extends
        ``attr_order[seed_width + li]``."""
        return len(self.seed_cols)

    def index_ids(self) -> List[Tuple[str, str, Tuple[int, ...], int, str]]:
        """All (index_id, rel, key_positions, ext_position, version) needed.

        Positions are column positions *within the atom*, so index building
        does not depend on attribute numbering.
        """
        out = []
        seen = set()

        def add(b: Binding, atom: Atom, version: str):
            if b.index_id in seen:
                return
            seen.add(b.index_id)
            key_pos = tuple(atom.attrs.index(a) for a in b.key_attrs)
            ext_pos = atom.attrs.index(b.ext_attr)
            out.append((b.index_id, b.rel, key_pos, ext_pos, version))

        for b in self.seed_filters:
            add(b, self.query.atoms[b.atom_idx], self.versions[b.atom_idx])
        for lv in self.levels:
            for b in lv.bindings:
                add(b, self.query.atoms[b.atom_idx], self.versions[b.atom_idx])
        return out


def _index_id(atom_idx: int, key_attrs: Tuple[int, ...], ext: int,
              version: str) -> str:
    k = ",".join(map(str, key_attrs))
    return f"at{atom_idx}[{k}->{ext}]@{version}"


def choose_attribute_order(q: Query, seed_atom: Optional[int] = None,
                           seed_prefix: int = 2,
                           ) -> Tuple[Tuple[int, ...], int]:
    """Greedy order: start with the seed atom's first ``seed_prefix``
    attributes (2 for projection-seeded plans; the full atom for dR-seeded
    delta plans, Thm 3.2), then repeatedly pick the attribute constrained by
    the most already-bound atoms (ties: smallest id).
    Returns (order, seed_atom)."""
    if seed_atom is None:
        # prefer a binary atom; the attr pair covered by most atoms is a good
        # seed (more filters applied at P_2).  Fall back to any atom's first
        # two attributes (projection-seeded, e.g. the ternary tri relation).
        binary = [i for i, a in enumerate(q.atoms) if a.arity == 2]
        def pair_cover(i):
            s = set(q.atoms[i].attrs[:2])
            return sum(1 for a in q.atoms if set(a.attrs) <= s)
        pool = binary if binary else list(range(q.num_atoms))
        seed_atom = max(pool, key=pair_cover)
    first = q.atoms[seed_atom]
    order = list(first.attrs[:max(int(seed_prefix), 2)])
    bound = set(order)
    while len(order) < q.num_attrs:
        def score(a):
            if a in bound:
                return -1
            return sum(
                1 for atom in q.atoms
                if a in atom.attrs and any(x in bound for x in atom.attrs)
            )
        cand = max((a for a in range(q.num_attrs) if a not in bound),
                   key=lambda a: (score(a), -a))
        if score(cand) == 0:
            raise ValueError("query is disconnected; unsupported seed order")
        order.append(cand)
        bound.add(cand)
    return tuple(order), seed_atom


def make_plan(q: Query, attr_order: Optional[Sequence[int]] = None,
              seed_atom: Optional[int] = None,
              versions: Optional[Sequence[str]] = None,
              seed_width: int = 2) -> Plan:
    """Build the level-by-level plan for ``q`` under ``attr_order``.

    ``seed_width`` is the seed-prefix width: 2 for projection-seeded static
    plans (P_2), the seed atom's arity for dR-seeded delta plans — the
    first ``seed_width`` attributes of the order must be the seed atom's
    attributes, and extension levels cover ``attr_order[seed_width:]``.
    """
    sw = int(seed_width)
    if attr_order is None:
        attr_order, seed_atom = choose_attribute_order(q, seed_atom, sw)
    else:
        attr_order = tuple(attr_order)
        if seed_atom is None:
            for i, atom in enumerate(q.atoms):
                if set(attr_order[:sw]) <= set(atom.attrs):
                    seed_atom = i
                    break
            else:
                raise ValueError(
                    f"no atom covers the first {sw} attributes")
    if versions is None:
        versions = tuple("static" for _ in q.atoms)
    else:
        versions = tuple(versions)

    seed_attrs = attr_order[:sw]
    seed = q.atoms[seed_atom]
    if not set(seed_attrs) <= set(seed.attrs):
        raise ValueError(
            f"seed atom does not cover the first {sw} attributes")
    seed_cols = tuple(seed.attrs.index(a) for a in seed_attrs)

    # Other atoms fully contained in the seed prefix become membership
    # filters on the seed tuples (§4.2): key = all-but-last attr, in atom
    # order, ext = the last — covered by composite keys up to arity 4.
    seed_filters = []
    for i, atom in enumerate(q.atoms):
        if i == seed_atom or not set(atom.attrs) <= set(seed_attrs):
            continue
        key = atom.attrs[:-1]
        ext = atom.attrs[-1]
        seed_filters.append(Binding(
            i, atom.rel, key, ext,
            _index_id(i, key, ext, versions[i]), True))
    seed_ineq = tuple(f for f in q.filters
                      if {f.lo, f.hi} <= set(seed_attrs))

    levels: List[LevelPlan] = []
    bound: List[int] = list(seed_attrs)
    done_filters = set(id(f) for f in seed_ineq)
    for ext in attr_order[sw:]:
        bindings = []
        for i, atom in enumerate(q.atoms):
            if ext not in atom.attrs:
                continue
            bound_in_atom = tuple(a for a in atom.attrs
                                  if a in bound)
            if not bound_in_atom:
                continue  # constrains nothing yet
            free = [a for a in atom.attrs if a not in bound and a != ext]
            bindings.append(Binding(
                i, atom.rel, bound_in_atom, ext,
                _index_id(i, bound_in_atom, ext, versions[i]),
                is_last=not free))
        if not bindings:
            raise ValueError(f"attribute a{ext} unconstrained at its level")
        ineq = tuple(
            f for f in q.filters
            if id(f) not in done_filters
            and {f.lo, f.hi} <= set(bound) | {ext})
        done_filters.update(id(f) for f in ineq)
        levels.append(LevelPlan(ext, tuple(bound), tuple(bindings), ineq))
        bound.append(ext)

    return Plan(q, tuple(attr_order), seed_atom, seed_cols,
                tuple(seed_filters), seed_ineq, tuple(levels), versions)


def make_delta_plan(dq: DeltaQuery,
                    attr_order: Optional[Sequence[int]] = None) -> Plan:
    """Plan for dQ_i: the attribute order starts with ALL of atom i's
    attributes (Thm 3.2) and the dataflow is seeded from dR_i's full tuples
    — width-2 prefixes for binary atoms, width-r for an n-ary dR_i (every
    seed tuple binds the whole atom at once, so the dataflow starts at P_r
    and skips the first r-2 extension levels); atoms k<i read version
    'new', atoms k>i read 'old' (§3.3)."""
    q = dq.query
    seed = q.atoms[dq.seed_atom]
    sw = seed.arity
    if attr_order is None:
        rest_order, _ = choose_attribute_order(q, seed_atom=dq.seed_atom,
                                               seed_prefix=sw)
        attr_order = rest_order
    if set(attr_order[:sw]) != set(seed.attrs):
        raise ValueError(
            "delta attribute order must start with the seed atom's attrs")
    return make_plan(q, attr_order, dq.seed_atom, dq.versions,
                     seed_width=sw)
