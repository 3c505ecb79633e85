"""Textual pattern DSL for conjunctive subgraph queries.

One pattern per string, datalog-ish::

    tri(a, b, c)  := e(a, b), e(a, c), e(b, c)
    diam(a,b,c,d) := e(a,b), e(b,c), e(d,a), e(d,c)
    sym3(a,b,c)   := e(a,b), e(a,c), e(b,c), a < b, b < c

Head variables fix the attribute order (attribute ``i`` is the i-th head
variable); body terms are relational atoms (``e``/``edge`` is the graph's
binary edge relation; any other name — e.g. ``tri`` — names a stored
relation) or ``x < y`` symmetry-breaking inequality filters.  The result is
a plain :class:`repro_torch.core.query.Query`, so parsed patterns and the
hand-built motifs of ``core/query.py`` are interchangeable everywhere.
"""
from __future__ import annotations

import re
from typing import List

from repro_torch.core.query import EDGE, Atom, Filter, Query

_HEAD_RE = re.compile(
    r"^\s*(?P<name>[A-Za-z0-9_-]+)\s*\(\s*(?P<vars>[^)]*)\)\s*$")
_ATOM_RE = re.compile(
    r"^\s*(?P<rel>[A-Za-z_]\w*)\s*\(\s*(?P<vars>[^)]*)\)\s*$")
_INEQ_RE = re.compile(
    r"^\s*(?P<lo>[A-Za-z_]\w*)\s*<\s*(?P<hi>[A-Za-z_]\w*)\s*$")
_VAR_RE = re.compile(r"^[A-Za-z_]\w*$")


class PatternSyntaxError(ValueError):
    """Raised on malformed pattern text (the message cites the bad part)."""


def _split_terms(body: str) -> List[str]:
    """Split the body on commas OUTSIDE parentheses."""
    terms, depth, cur = [], 0, []
    for ch in body:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                raise PatternSyntaxError(f"unbalanced ')' in {body!r}")
        if ch == "," and depth == 0:
            terms.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth:
        raise PatternSyntaxError(f"unbalanced '(' in {body!r}")
    terms.append("".join(cur))
    return [t for t in terms if t.strip()]


def _parse_vars(raw: str, where: str) -> List[str]:
    names = [v.strip() for v in raw.split(",")] if raw.strip() else []
    for v in names:
        if not _VAR_RE.match(v):
            raise PatternSyntaxError(f"bad variable {v!r} in {where}")
    return names


def parse_pattern(text: str, name: str = None) -> Query:
    """Parse one pattern string into a :class:`Query`.

    Raises :class:`PatternSyntaxError` for malformed text and
    ``ValueError`` for semantically bad patterns (unbound variables, arity
    mismatches, head variables no atom covers).
    """
    if ":=" not in text:
        raise PatternSyntaxError(
            f"pattern needs 'head(vars) := body': {text!r}")
    head_txt, body_txt = text.split(":=", 1)
    m = _HEAD_RE.match(head_txt)
    if not m:
        raise PatternSyntaxError(f"bad pattern head {head_txt.strip()!r}")
    qname = name if name is not None else m.group("name")
    head_vars = _parse_vars(m.group("vars"), "head")
    if not head_vars:
        raise PatternSyntaxError("pattern head has no variables")
    if len(set(head_vars)) != len(head_vars):
        raise PatternSyntaxError(
            f"repeated variable in head {head_txt.strip()!r}")
    attr_of = {v: i for i, v in enumerate(head_vars)}

    atoms: List[Atom] = []
    filters: List[Filter] = []
    arity_of = {}
    for term in _split_terms(body_txt):
        iq = _INEQ_RE.match(term)
        if iq:
            lo, hi = iq.group("lo"), iq.group("hi")
            for v in (lo, hi):
                if v not in attr_of:
                    raise ValueError(
                        f"unbound variable {v!r} in filter {term.strip()!r}")
            filters.append(Filter(attr_of[lo], attr_of[hi]))
            continue
        am = _ATOM_RE.match(term)
        if not am:
            raise PatternSyntaxError(f"bad body term {term.strip()!r}")
        rel = am.group("rel")
        vs = _parse_vars(am.group("vars"), f"atom {term.strip()!r}")
        for v in vs:
            if v not in attr_of:
                raise ValueError(
                    f"unbound variable {v!r} in atom {term.strip()!r} "
                    f"(head vars: {', '.join(head_vars)})")
        if rel in ("e", EDGE):
            rel = EDGE
            if len(vs) != 2:
                raise ValueError(
                    f"arity mismatch: edge atom {term.strip()!r} must be "
                    "binary")
        want = arity_of.setdefault(rel, len(vs))
        if want != len(vs):
            raise ValueError(
                f"arity mismatch: relation {rel!r} used with arity "
                f"{len(vs)} after arity {want}")
        atoms.append(Atom(rel, tuple(attr_of[v] for v in vs)))
    if not atoms:
        raise PatternSyntaxError("pattern body has no atoms")
    # Query.__post_init__ rejects uncovered head attrs / repeated atom vars
    return Query(qname, len(head_vars), tuple(atoms), tuple(filters))


_DEF_VARS = "abcdefghijklmnopqrstuvwxyz"


def pattern_of(q: Query) -> str:
    """Serialize a Query back to DSL text; ``parse_pattern(pattern_of(q))``
    reproduces ``q`` exactly (atom order, filters, name)."""
    if q.num_attrs > len(_DEF_VARS):
        raise ValueError("too many attributes to serialize")
    v = _DEF_VARS[:q.num_attrs]
    head = f"{q.name}({', '.join(v)})"
    terms: List[str] = []
    for atom in q.atoms:
        rel = "e" if atom.rel == EDGE else atom.rel
        terms.append(f"{rel}({', '.join(v[a] for a in atom.attrs)})")
    for f in q.filters:
        terms.append(f"{v[f.lo]} < {v[f.hi]}")
    return f"{head} := {', '.join(terms)}"
