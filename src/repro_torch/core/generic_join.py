"""Serial Generic Join (§2.2) — numpy implementation.

The *oracle* every dataflow of the port is tested against: a host-only,
framework-free evaluation of the same plans over the same packed keys;
and, copied from the JAX package, the baselines of the paper's
comparisons: the *edge-at-a-time* binary join (§1.2.1), whose
intermediate results blow up where Generic Join's cannot, and the
single-threaded triangle count of the COST experiment (Fig 4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import csr
from repro_torch.core.plan import Plan, make_plan
from repro_torch.core.query import Query


@dataclasses.dataclass
class WorkCounters:
    """Operation counts for worst-case-optimality property tests (Lemma 3.1:
    total work is O(m n MaxOut_Q))."""

    proposals: int = 0
    intersections: int = 0
    count_lookups: int = 0

    @property
    def total(self) -> int:
        return self.proposals + self.intersections + self.count_lookups


class _NpIndex:
    """Host-side sorted extension index (numpy mirror of csr.IndexData).

    Keys come from the ONE shared packer (``csr.pack_key``): a single int64
    word for <= 2 bound columns, a lexicographic (hi, lo) pair for 3-4 —
    so the host oracle and the device indices agree by construction.
    """

    def __init__(self, tuples: np.ndarray, key_pos: Tuple[int, ...],
                 ext_pos: int):
        tuples = np.asarray(tuples)
        key = csr.pack_key(tuple(tuples[:, p].astype(np.int32)
                                 for p in key_pos)) if key_pos else \
            np.zeros(tuples.shape[0], np.int64)
        val = tuples[:, ext_pos].astype(np.int64)
        if isinstance(key, tuple):  # composite (hi, lo) key
            kvl = np.unique(np.stack([key[0], key[1], val], 1), axis=0) \
                if val.size else np.zeros((0, 3), np.int64)
            self.key, self.lo = kvl[:, 0], kvl[:, 1]
            self.val = kvl[:, 2].astype(np.int32)
            self._packed = None
            return
        self.lo = None
        kv = np.unique(np.stack([key, val], 1), axis=0) if key.size else \
            np.zeros((0, 2), np.int64)
        self.key = kv[:, 0]
        self.val = kv[:, 1].astype(np.int32)
        # membership fast path: packed (key,val) when key fits in 31 bits
        self._packed = ((self.key << 32) | kv[:, 1]
                        if (self.key < 2**31).all() else None)

    def ranges(self, qkey) -> Tuple[np.ndarray, np.ndarray]:
        if self.lo is not None:
            qh, ql = qkey
            s = _lex_searchsorted_np((self.key, self.lo), (qh, ql), "left")
            e = _lex_searchsorted_np((self.key, self.lo), (qh, ql), "right")
            return s, (e - s)
        s = np.searchsorted(self.key, qkey, "left")
        e = np.searchsorted(self.key, qkey, "right")
        return s, (e - s)

    def member(self, qkey, qval: np.ndarray) -> np.ndarray:
        qv = qval.astype(np.int64)
        if self.lo is not None:
            qh, ql = qkey
            return _lex_hit_np((self.key, self.lo, self.val.astype(np.int64)),
                               (qh, ql, qv))
        if self._packed is not None:
            q = (qkey.astype(np.int64) << 32) | qv
            pos = np.searchsorted(self._packed, q)
            pos_c = np.minimum(pos, max(len(self._packed) - 1, 0))
            return (len(self._packed) > 0) & (self._packed[pos_c] == q)
        # keys >= 2^31 cannot be packed: vectorized lexicographic binary
        # search over the sorted (key, val) pairs (np.unique sorted them)
        return _lex_hit_np((self.key, self.val.astype(np.int64)), (qkey, qv))


def _lex_searchsorted_np(cols: Tuple[np.ndarray, ...],
                         qcols: Tuple[np.ndarray, ...],
                         side: str = "left") -> np.ndarray:
    """Vectorized lower/upper bound over up-to-3 lex-sorted int64 columns —
    the numpy mirror of ``csr.lex_searchsorted_cols`` (fixed-depth binary
    search: O(B log n) vector ops instead of per-query Python probes)."""
    n = cols[0].shape[0]
    right = side == "right"
    if n == 0:
        return np.zeros(np.asarray(qcols[0]).shape[0], np.int64)
    lo = np.zeros(qcols[0].shape[0], np.int64)
    hi = np.full(qcols[0].shape[0], n, np.int64)
    for _ in range(max(int(np.ceil(np.log2(max(n, 2)))), 1) + 1):
        mid = (lo + hi) >> 1
        mc = np.minimum(mid, n - 1)
        less = np.zeros(lo.shape[0], bool)
        eq = np.ones(lo.shape[0], bool)
        for c, q in zip(cols, qcols):
            v = c[mc]
            less |= eq & (v < q)
            eq &= v == q
        if right:
            less |= eq
        sel = lo < hi
        lo = np.where(less & sel, mid + 1, lo)
        hi = np.where(~less & sel, mid, hi)
    return lo


def _lex_hit_np(cols, qcols) -> np.ndarray:
    """Exact-match membership of lex queries in lex-sorted columns."""
    n = cols[0].shape[0]
    if n == 0:
        return np.zeros(np.asarray(qcols[0]).shape[0], bool)
    pos = _lex_searchsorted_np(cols, qcols, "left")
    pc = np.minimum(pos, n - 1)
    hit = pos < n
    for c, q in zip(cols, qcols):
        hit &= c[pc] == q
    return hit


def _lex_member_np(key: np.ndarray, val: np.ndarray, qk: np.ndarray,
                   qv: np.ndarray) -> np.ndarray:
    """Back-compat wrapper: (key, val) membership via the generic search."""
    return _lex_hit_np((key, val.astype(np.int64)),
                       (qk, qv.astype(np.int64)))


def build_np_indices(plan: Plan, relations: Dict[str, np.ndarray]
                     ) -> Dict[str, _NpIndex]:
    out = {}
    for index_id, rel, key_pos, ext_pos, _version in plan.index_ids():
        out[index_id] = _NpIndex(relations[rel], key_pos, ext_pos)
    return out


def _pack_prefix_key(prefix: np.ndarray, bound_attrs: Tuple[int, ...],
                     key_attrs: Tuple[int, ...]):
    """Pack the bound prefix columns named by ``key_attrs`` — delegates to
    the shared ``csr.pack_key`` (single word, or (hi, lo) for 3-4 cols)."""
    return csr.pack_key(tuple(
        prefix[:, bound_attrs.index(a)].astype(np.int64)
        for a in key_attrs))


def generic_join(query: Query, relations: Dict[str, np.ndarray],
                 plan: Optional[Plan] = None,
                 seed: Optional[np.ndarray] = None,
                 counters: Optional[WorkCounters] = None,
                 enumerate_results: bool = True) -> Tuple[np.ndarray, int]:
    """Run serial GJ.  Returns (results [N, m] in attribute order, count).

    ``seed`` overrides P_2 (used by delta evaluation: seed = dR_i tuples,
    already oriented as (attr_order[0], attr_order[1]) values).
    """
    plan = plan or make_plan(query)
    idx = build_np_indices(plan, relations)
    m = query.num_attrs

    # ---- P_2 --------------------------------------------------------------
    if seed is None:
        rel = np.asarray(relations[query.atoms[plan.seed_atom].rel], np.int64)
        seed_tuples = np.unique(rel[:, list(plan.seed_cols)], axis=0)
    else:
        seed_tuples = np.asarray(seed, np.int64).reshape(
            -1, plan.seed_width)
    prefix = seed_tuples.astype(np.int64)
    bound = tuple(plan.attr_order[:plan.seed_width])
    for b in plan.seed_filters:
        qk = _pack_prefix_key(prefix, bound, b.key_attrs)
        qv = prefix[:, bound.index(b.ext_attr)]
        keep = idx[b.index_id].member(qk, qv)
        if counters:
            counters.intersections += len(prefix)
        prefix = prefix[keep]
    for f in plan.seed_ineq:
        keep = prefix[:, bound.index(f.lo)] < prefix[:, bound.index(f.hi)]
        prefix = prefix[keep]

    # ---- prefix extension levels ------------------------------------------
    for lv in plan.levels:
        if prefix.shape[0] == 0:
            prefix = np.zeros((0, len(lv.bound_attrs) + 1), np.int64)
            continue
        nb = len(lv.bindings)
        starts = np.zeros((nb, prefix.shape[0]), np.int64)
        counts = np.zeros((nb, prefix.shape[0]), np.int64)
        for bi, b in enumerate(lv.bindings):
            qk = _pack_prefix_key(prefix, lv.bound_attrs, b.key_attrs)
            s, c = idx[b.index_id].ranges(qk)
            starts[bi], counts[bi] = s, c
            if counters:
                counters.count_lookups += len(prefix)
        min_i = np.argmin(counts, axis=0)
        min_c = counts[min_i, np.arange(prefix.shape[0])]
        min_s = starts[min_i, np.arange(prefix.shape[0])]
        total = int(min_c.sum())
        if counters:
            counters.proposals += total
        # ragged expand: proposal t belongs to prefix row[t], offset k[t]
        row = np.repeat(np.arange(prefix.shape[0]), min_c)
        cum = np.concatenate([[0], np.cumsum(min_c)])
        k = np.arange(total) - cum[row]
        ext_pos = min_s[row] + k
        # gather candidate extensions from the proposing index
        cand = np.zeros(total, np.int64)
        for bi, b in enumerate(lv.bindings):
            sel = min_i[row] == bi
            if sel.any():
                cand[sel] = idx[b.index_id].val[ext_pos[sel]]
        keep = np.ones(total, bool)
        new_prefix = np.concatenate([prefix[row], cand[:, None]], axis=1)
        new_bound = lv.bound_attrs + (lv.ext_attr,)
        for bi, b in enumerate(lv.bindings):
            sel = keep & (min_i[row] != bi)
            if counters:
                counters.intersections += int(sel.sum())
            if not sel.any():
                continue
            qk = _pack_prefix_key(new_prefix[sel], new_bound, b.key_attrs)
            qv = new_prefix[sel, -1]
            ok = idx[b.index_id].member(qk, qv)
            keep[np.where(sel)[0][~ok]] = False
        for f in lv.filters:
            lo = new_prefix[:, new_bound.index(f.lo)]
            hi = new_prefix[:, new_bound.index(f.hi)]
            keep &= lo < hi
        prefix = new_prefix[keep]
        bound = new_bound

    # reorder columns from attr order to attribute id order
    perm = np.argsort(np.asarray(plan.attr_order))
    result = prefix[:, perm] if enumerate_results else prefix[:0]
    return result.astype(np.int32), int(prefix.shape[0])


# ---------------------------------------------------------------------------
# Edge-at-a-time (binary join) baseline — §1.2.1.
# ---------------------------------------------------------------------------

class IntermediateBlowup(RuntimeError):
    pass


def binary_join(query: Query, relations: Dict[str, np.ndarray],
                max_intermediate: int = 50_000_000,
                ) -> Tuple[np.ndarray, int, int]:
    """Left-deep binary join in a greedy connected atom order.

    Returns (results, count, peak_intermediate).  Raises IntermediateBlowup
    if any intermediate exceeds ``max_intermediate`` rows — the failure mode
    the paper's worst-case-optimal approach provably avoids.
    """
    atoms = list(query.atoms)
    order = [0]
    bound = set(atoms[0].attrs)
    remaining = set(range(1, len(atoms)))
    while remaining:
        nxt = max(remaining,
                  key=lambda i: len(set(atoms[i].attrs) & bound))
        if not set(atoms[nxt].attrs) & bound:
            raise ValueError("disconnected query")
        order.append(nxt)
        bound |= set(atoms[nxt].attrs)
        remaining.discard(nxt)

    first = atoms[order[0]]
    cur = np.asarray(relations[first.rel], np.int64)
    cur_attrs = list(first.attrs)
    peak = cur.shape[0]
    for oi in order[1:]:
        atom = atoms[oi]
        rel = np.asarray(relations[atom.rel], np.int64)
        shared = [a for a in atom.attrs if a in cur_attrs]
        new = [a for a in atom.attrs if a not in cur_attrs]
        kc = [cur_attrs.index(a) for a in shared]
        kr = [atom.attrs.index(a) for a in shared]

        def pk(arr, cols):
            key = arr[:, cols[0]].astype(np.int64)
            for c in cols[1:]:
                key = (key << 21) | arr[:, c].astype(np.int64)
            return key

        ck, rk = pk(cur, kc), pk(rel, kr)
        srt = np.argsort(rk, kind="stable")
        rk_s, rel_s = rk[srt], rel[srt]
        s = np.searchsorted(rk_s, ck, "left")
        e = np.searchsorted(rk_s, ck, "right")
        cnt = e - s
        total = int(cnt.sum())
        peak = max(peak, total)
        if total > max_intermediate:
            raise IntermediateBlowup(
                f"intermediate of {total} rows exceeds cap "
                f"{max_intermediate} at atom {atom}")
        row = np.repeat(np.arange(cur.shape[0]), cnt)
        cum = np.concatenate([[0], np.cumsum(cnt)])
        k = np.arange(total) - cum[row]
        match = rel_s[s[row] + k]
        new_cols = [match[:, atom.attrs.index(a)][:, None] for a in new]
        cur = np.concatenate([cur[row]] + new_cols, axis=1)
        cur_attrs = cur_attrs + new
    for f in query.filters:
        keep = cur[:, cur_attrs.index(f.lo)] < cur[:, cur_attrs.index(f.hi)]
        cur = cur[keep]
    perm = [cur_attrs.index(a) for a in range(query.num_attrs)]
    out = cur[:, perm]
    out = np.unique(out, axis=0)  # binary joins can duplicate under dedup'd
    return out.astype(np.int32), int(out.shape[0]), peak


# ---------------------------------------------------------------------------
# Optimized single-threaded triangle count (COST baseline, Fig 4).
# ---------------------------------------------------------------------------

def fast_triangle_count(edges: np.ndarray) -> int:
    """Degree-ordered merge-intersection triangle counting; vectorized numpy.

    Counts triangles of the *undirected* graph induced by ``edges`` (the
    standard COST formulation).
    """
    e = np.asarray(edges, np.int64)
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    keep = lo != hi
    e = np.unique(np.stack([lo[keep], hi[keep]], 1), axis=0)
    nv = int(e.max()) + 1 if e.size else 0
    deg = np.bincount(e.reshape(-1), minlength=nv)
    rank = np.empty(nv, np.int64)
    rank[np.lexsort((np.arange(nv), deg))] = np.arange(nv)
    a, b = rank[e[:, 0]], rank[e[:, 1]]
    src = np.minimum(a, b)
    dst = np.maximum(a, b)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    packed = (src << 32) | dst
    # For each edge (u,v): |N+(u) ∩ N+(v)| via membership probes of the
    # smaller out-neighborhood against packed edges.
    starts = np.searchsorted(src, np.arange(nv), "left")
    ends = np.searchsorted(src, np.arange(nv), "right")
    cnt_u = ends[src] - starts[src]
    cnt_v = ends[dst] - starts[dst]
    small_is_u = cnt_u <= cnt_v
    probe_n = np.where(small_is_u, cnt_u, cnt_v)
    probe_start = np.where(small_is_u, starts[src], starts[dst])
    other = np.where(small_is_u, dst, src)
    total = int(probe_n.sum())
    row = np.repeat(np.arange(src.shape[0]), probe_n)
    cum = np.concatenate([[0], np.cumsum(probe_n)])
    k = np.arange(total) - cum[row]
    w = dst[probe_start[row] + k]
    q = (other[row].astype(np.int64) << 32) | w
    pos = np.searchsorted(packed, q)
    pos_c = np.minimum(pos, len(packed) - 1)
    return int((packed[pos_c] == q).sum())
