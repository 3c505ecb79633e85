"""n-ary relations in the port (plain versions on the CPU) against the JAX
package, exact (integer tolerance 0, dtypes included): composite (hi, lo)
keys in the sorted indices, the composite variants of the four kernels
(against the JAX kernels in interpret mode and their jnp references), a
store holding ``tri``, ``quad`` and ``edge`` region for region, the
4-clique-tri session epoch for epoch against ``repro.api.GraphSession``
and against the edge-only 4-clique, 5-clique-quad likewise against the JAX
session and against 5-clique, and the relation and batch validation
errors."""
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import csr as jcsr
from repro.core import delta as jdelta
from repro.kernels.extend.ops import fused_extend as j_fused_extend
from repro.kernels.intersect.ops import signed_member as j_signed_member
from repro.kernels.merge import fold as jfold
from repro.kernels.merge.merge import rank_counts as j_rank_counts
from repro.kernels.merge.ref import rank_ref as j_rank_ref
from repro_torch import convert
from repro_torch import kernels as tkernels
from repro_torch.api import GraphSession, canon_signed
from repro_torch.core import csr as tcsr
from repro_torch.core import delta as tdelta
from repro_torch.kernels.extend.ops import fused_extend
from repro_torch.kernels.intersect.ops import signed_member
from repro_torch.kernels.merge.fold import commit_fold
from repro_torch.kernels.merge.ops import rank_lt_le

from tests.test_torch_csr import same

FIVE_CLIQUE_QUAD = ("5-clique-quad(a,b,c,d,e) := quad(a,b,c,d), "
                    "quad(a,b,c,e), e(d,e)")


def same_index(t, j):
    """A port region equals a JAX one: key, lo, val and n, dtypes too."""
    same(t.key, j.key)
    same(t.val, j.val)
    assert int(t.n) == int(j.n)
    assert t.n.dtype == torch.int32 and t.n.dim() == 0
    assert (t.lo is None) == (j.lo is None)
    if t.lo is not None:
        same(t.lo, j.lo)


def rows(rng, n, arity, nv):
    return rng.integers(0, nv, (max(n, 0), arity)).astype(np.int32)


def comp_pair(rng, n, k, narrow, nv=6, capacity=None):
    """One composite index (k = 3 or 4 key columns) in both packages."""
    t = rows(rng, n, k + 1, nv)
    key_pos = tuple(range(k))
    return (jcsr.build_index(t, key_pos, k, capacity, narrow=narrow),
            tcsr.build_index(t, key_pos, k, capacity, narrow=narrow,
                             device="cpu"))


def comp_queries(rng, B, k, nv=6, narrow=False):
    """(hi, lo) queries with three padding rows, sentinel-padded the way
    the layout pads its own entries (a narrow hi word with int32-max)."""
    q = rows(rng, B, k + 1, nv)
    jk = jcsr.pack_key(tuple(q[:, c] for c in range(k)))
    jk = tuple(np.asarray(x).copy() for x in jk)
    jk[0][:3] = jcsr.SENTINEL32 if narrow else jcsr.SENTINEL
    jk[1][:3] = jcsr.SENTINEL
    qv = q[:, k]
    return ((jnp.asarray(jk[0]), jnp.asarray(jk[1])), jnp.asarray(qv),
            (torch.from_numpy(jk[0]), torch.from_numpy(jk[1])),
            torch.from_numpy(qv))


# layouts: 3 key columns with a narrow (int32) or wide hi word; 4 columns
LAYOUTS = [(3, True), (3, False), (4, False)]
LAYOUT_IDS = ["k3-i32", "k3-i64", "k4-i64"]


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU every wrapper takes its plain version: no launch."""
    tkernels.reset_launches()
    yield
    assert sum(tkernels.launches().values()) == 0


# ---------------------------------------------------------------------------
# composite csr primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 4])
def test_pack_and_unpack_composite(k):
    rng = np.random.default_rng(k)
    cols = [rng.integers(0, 2**31 - 1, 50).astype(np.int32)
            for _ in range(k)]
    jp = jcsr.pack_key(cols)
    tp_np = tcsr.pack_key(cols)
    tp = tcsr.pack_key([torch.from_numpy(c) for c in cols])
    for a, b, c in zip(tp, tp_np, jp):
        same(a, c)
        np.testing.assert_array_equal(b, np.asarray(c))
    np.testing.assert_array_equal(tcsr.unpack_key(tp_np, k),
                                  jcsr.unpack_key(jp, k))
    with pytest.raises(ValueError, match="at most 4"):
        tcsr.pack_key([torch.from_numpy(cols[0])] * 5)


@pytest.mark.parametrize("k,narrow", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("n", [0, 1, 128, 300])
def test_build_composite_index_matches(k, narrow, n):
    rng = np.random.default_rng(10 + n)
    for cap in (None, 1000):  # 1000: padding past the live set
        j, t = comp_pair(rng, n, k, narrow, capacity=cap)
        same_index(t, j)
    je = jcsr.empty_index(300, narrow=narrow, composite=True)
    te = tcsr.empty_index(300, narrow=narrow, composite=True, device="cpu")
    same_index(te, je)
    # the auto choice narrows exactly when the hi word is one column
    j, t = comp_pair(rng, n, k, None)
    same_index(t, j)


@pytest.mark.parametrize("k,narrow", LAYOUTS, ids=LAYOUT_IDS)
def test_composite_searches_match(k, narrow):
    rng = np.random.default_rng(20 + k)
    # 128 live entries at capacity 128: padding-free full capacity
    for n, cap in ((300, None), (128, 128)):
        t = np.unique(rows(rng, 4 * n, k + 1, 6), axis=0)[:n]
        j = jcsr.build_index(t, tuple(range(k)), k, cap, narrow=narrow)
        tt = tcsr.build_index(t, tuple(range(k)), k, cap, narrow=narrow,
                              device="cpu")
        same_index(tt, j)
        jq, jv, tq, tv = comp_queries(rng, 257, k)
        for a, b in zip(tcsr.index_range(tt, tq), jcsr.index_range(j, jq)):
            same(a, b)
        same(tcsr.index_member(tt, tq, tv), jcsr.index_member(j, jq, jv))
        for plain in (True, False):
            got = tcsr.index_ranks(tt, tq, tv, plain=plain)
            for a, b in zip(got, jcsr.index_ranks(j, jq, jv)):
                same(a, b)


@pytest.mark.parametrize("k,narrow", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("seed", range(2))
def test_composite_merge_and_select_match(k, narrow, seed):
    rng = np.random.default_rng(30 + seed)
    ja, ta = comp_pair(rng, int(rng.integers(0, 150)), k, narrow, nv=4)
    jb, tb = comp_pair(rng, int(rng.integers(0, 150)), k, narrow, nv=4)
    for cap in (tcsr.round_capacity(ta.capacity + tb.capacity), 128):
        same_index(tcsr._merge_core(ta, tb, cap),
                   jcsr._merge_core(ja, jb, cap))
    for keep in (False, True):
        same_index(tcsr._select_core(ta, tb, ta.capacity, keep),
                   jcsr._select_core(ja, jb, ja.capacity, keep))


def test_convert_carries_lo():
    rng = np.random.default_rng(3)
    j, _ = comp_pair(rng, 90, 4, False)
    same_index(convert.index_of(j, device="cpu"), j)


# ---------------------------------------------------------------------------
# the composite kernel variants (plain versions) against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,narrow", LAYOUTS, ids=LAYOUT_IDS)
def test_signed_member_lex_matches_jax_kernel(k, narrow):
    rng = np.random.default_rng(40 + k + narrow)
    pos = [comp_pair(rng, int(rng.integers(0, 200)), k, narrow,
                     capacity=int(rng.integers(1, 300))) for _ in range(3)]
    neg = [comp_pair(rng, int(rng.integers(0, 60)), k, narrow)
           for _ in range(2)]
    jq, jv, tq, tv = comp_queries(rng, 300, k)
    jw = j_signed_member(tuple(j for j, _ in pos), tuple(j for j, _ in neg),
                         jq, jv)
    tw = signed_member([t for _, t in pos], [t for _, t in neg], tq, tv)
    for a, b in zip(tw, jw):
        same(a, b)
    assert int(tw[0].sum()) > 0
    with pytest.raises(ValueError, match="composite"):
        signed_member([t for _, t in pos], [], tq[0], tv)


@pytest.mark.parametrize("k,narrow", LAYOUTS, ids=LAYOUT_IDS)
def test_rank_lex_matches_jax_kernel_and_ref(k, narrow):
    """Against the jnp reference on every query; against the JAX kernel on
    the real ones.  For the three sentinel-padded queries the JAX kernel
    counts whole padding segments (256 where its reference gives n); the
    merges it serves mask those rows, and the port follows the reference."""
    rng = np.random.default_rng(50 + k + narrow)
    j, t = comp_pair(rng, 170, k, narrow, capacity=300)
    jq, jv, tq, tv = comp_queries(rng, 131, k, narrow=narrow)
    got = rank_lt_le(t.key, t.val, t.n, tq[0], tv, lo=t.lo, qlo=tq[1])
    kern = j_rank_counts(j.key, j.val, j.n, jq[0], jv, interpret=True,
                         lo=j.lo, qlo=jq[1])
    ref = j_rank_ref(j.key, j.val, j.n, jq[0], jv, lo=j.lo, qlo=jq[1])
    for g, a, b in zip(got, kern, ref):
        same(g[3:], a[3:])
        same(g, b)
    assert (got[0][:3] == int(t.n)).all()


@pytest.mark.parametrize("k,narrow", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("seed", range(2))
def test_commit_fold_lex_matches_jax_kernel_and_chain(k, narrow, seed):
    rng = np.random.default_rng(60 + seed)
    base, ci, cd, ui, ud = (comp_pair(rng, int(rng.integers(0, m)), k,
                                      narrow, nv=4)
                            for m in (300, 150, 100, 120, 120))
    jl, je = jcsr.index_ranks(base[0], jcsr._qcols_of(ud[0]), ud[0].val)
    j_in_ba = (je > jl).astype(jnp.int32)
    tl, te = tcsr.index_ranks(base[1], tcsr._qcols_of(ud[1]), ud[1].val)
    in_ba = (te > tl).to(torch.int32)
    same(in_ba, j_in_ba)
    # seed 1 folds into a capacity too small for the union
    cap = 128 if seed else tcsr.round_capacity(ci[1].capacity
                                               + ui[1].capacity)
    got = commit_fold(ci[1], cd[1], ui[1], ud[1], in_ba, cins_cap=cap,
                      cdel_cap=cap)
    kern = jfold.commit_fold(ci[0], cd[0], ui[0], ud[0], j_in_ba,
                             cins_cap=cap, cdel_cap=cap, interpret=True)
    chain = jdelta._commit_fold_safe(base[0], ci[0], cd[0], ui[0], ud[0],
                                     cins_cap=cap, cdel_cap=cap,
                                     sharded=False, use_kernel=False)
    for g, a, b in zip(got, kern, chain):
        same_index(g, a)
        same_index(g, b)


@pytest.mark.parametrize("k,narrow", LAYOUTS, ids=LAYOUT_IDS)
def test_fused_extend_lex_matches_jax_kernel(k, narrow):
    """A level with a composite binding beside a 1-word one, as the
    5-clique-quad delta plans have ([[3, 1]] key columns)."""
    rng = np.random.default_rng(70 + k + narrow)
    W, B = 200, 256
    cpos = [comp_pair(rng, int(rng.integers(1, 250)), k, narrow)
            for _ in range(2)]
    cneg = [comp_pair(rng, int(rng.integers(0, 40)), k, narrow)]
    e = rows(rng, 300, 2, 6)
    opos = [(jcsr.build_index(e[:150], (0,), 1),
             tcsr.build_index(e[:150], (0,), 1, device="cpu"))]
    oneg = [(jcsr.build_index(e[150:170], (0,), 1),
             tcsr.build_index(e[150:170], (0,), 1, device="cpu"))]
    wq = rows(rng, W, k, 6)
    cq = jcsr.pack_key(tuple(wq[:, c] for c in range(k)))
    oq = rng.integers(0, 6, W).astype(np.int32)
    wk = rng.integers(0, 3, W).astype(np.int32)
    valid = np.arange(W) < int(rng.integers(1, W))
    jpos = (tuple(j for j, _ in cpos), tuple(j for j, _ in opos))
    jneg = (tuple(j for j, _ in cneg), tuple(j for j, _ in oneg))
    want = j_fused_extend(jpos, jneg,
                          ((jnp.asarray(cq[0]), jnp.asarray(cq[1])),
                           jnp.asarray(oq)),
                          jnp.asarray(wk), jnp.asarray(valid), B)
    got = fused_extend(
        [[t for _, t in cpos], [t for _, t in opos]],
        [[t for _, t in cneg], [t for _, t in oneg]],
        [(torch.from_numpy(cq[0]), torch.from_numpy(cq[1])),
         torch.from_numpy(oq)], torch.from_numpy(wk),
        torch.from_numpy(valid), B)
    for g, w in zip(got, want):
        same(g, w)
    assert int(got[5][0]) > 0


# ---------------------------------------------------------------------------
# a store of tri, quad and edge, region for region against the reference
# ---------------------------------------------------------------------------

def _apply_net(live, upd, w):
    """Set semantics of one batch: degenerate rows dropped, per-row net
    weight, inserts if absent, deletes if present."""
    upd = np.asarray(upd, np.int32)
    w = np.asarray(w, np.int64)
    keep = ~tdelta._degenerate_rows(upd)
    upd, w = upd[keep], w[keep]
    if upd.size == 0:
        return live
    uniq, inv = np.unique(upd, axis=0, return_inverse=True)
    net = np.zeros(uniq.shape[0], np.int64)
    np.add.at(net, inv.reshape(-1), w)
    exists = tdelta.rows_isin(uniq, live)
    add = uniq[(net > 0) & ~exists]
    rem = uniq[(net < 0) & exists]
    kept = live[~tdelta.rows_isin(live, rem)]
    out = np.concatenate([kept, add])
    return np.unique(out, axis=0) if out.size else out


def _dirty_batch(rng, nv, live, size, arity):
    """Inserts (duplicates, degenerate rows, live rows), deletes of live
    and absent rows, and now and then a batch that nets to nothing."""
    if rng.integers(0, 5) == 0 and live.shape[0]:
        r = live[rng.integers(0, live.shape[0], max(size // 2, 1))]
        dg = np.tile(np.arange(2, dtype=np.int32)[:, None], (1, arity))
        return (np.concatenate([r, r, dg]),
                np.concatenate([np.ones(r.shape[0], np.int32),
                                -np.ones(r.shape[0], np.int32),
                                np.ones(2, np.int32)]))
    ins = rows(rng, int(rng.integers(0, size + 1)), arity, nv)
    n_del = int(rng.integers(0, size // 2 + 1))
    dl = live[rng.choice(live.shape[0], min(n_del, live.shape[0]),
                         replace=False)] if live.shape[0] else ins[:0]
    absent = rows(rng, 2, arity, nv)
    upd = np.concatenate([ins, dl, absent])
    w = np.concatenate([np.ones(ins.shape[0], np.int32),
                        -np.ones(dl.shape[0] + 2, np.int32)])
    return upd, w


def _store_pair(rng, nv):
    rels = {"tri": np.unique(rows(rng, 80, 3, nv), axis=0),
            "quad": np.unique(rows(rng, 60, 4, nv), axis=0),
            "edge": np.unique(rows(rng, 40, 2, nv), axis=0)}
    js = jdelta.RegionStore({k: v.copy() for k, v in rels.items()},
                            compact_ratio=0.4)
    ts = tdelta.RegionStore({k: v.copy() for k, v in rels.items()},
                            compact_ratio=0.4, device="cpu")
    for s in (js, ts):
        s.ensure("tri", (0, 1), 2)  # one packed int64 word
        s.ensure("quad", (0, 1, 2), 3)  # composite, narrow hi
        s.ensure("edge", (0,), 1)
        s.ensure("tri", (0,), 2)  # derived: ignores column 1
    return rels, js, ts


def _stores_equal(js, ts):
    assert set(js.projections) == set(ts.projections)
    for proj, jr in js.projections.items():
        tr = ts.projections[proj]
        assert tr.derived == jr.derived and tr.narrow == jr.narrow
        if jr.derived:
            for v in ("old", "new"):
                same_index(tr.versioned(v).pos[0], jr.versioned(v).pos[0])
            continue
        for name in ("base", "cins", "cdel"):
            same_index(getattr(tr, "d_" + name), getattr(jr, "d_" + name))
        assert (tr.n_base, tr.n_cins, tr.n_cdel) == \
            (jr.n_base, jr.n_cins, jr.n_cdel)
    for rel, jl in js._rels.items():
        tl = ts._rels[rel]
        for name in ("lb", "lc_ins", "lc_del"):
            same_index(getattr(tl, name), getattr(jl, name))
        assert list(tl.n_live) == [int(x) for x in jl.n_live]


def test_mixed_nary_store_matches_jax_region_for_region():
    rng = np.random.default_rng(80)
    nv = 10
    rels, js, ts = _store_pair(np.random.default_rng(77), nv)
    cur = {k: v.copy() for k, v in rels.items()}
    for step in range(10):
        batch = {name: _dirty_batch(rng, nv, cur[name], 8, ar)
                 for name, ar in (("tri", 3), ("quad", 4), ("edge", 2))}
        jo = js.normalize({k: (u.copy(), w.copy())
                           for k, (u, w) in batch.items()})
        to = ts.normalize({k: (u.copy(), w.copy())
                           for k, (u, w) in batch.items()})
        for rel in jo:
            for a, b in zip(to[rel], jo[rel]):
                np.testing.assert_array_equal(a, b)
        if any(a.size or b.size for a, b in to.values()):
            for s, o in ((js, jo), (ts, to)):
                s.begin_epoch(o)
            _stores_equal(js, ts)  # staged: derived "new" images too
            for s, o in ((js, jo), (ts, to)):
                s.commit(o)
        for name in cur:
            cur[name] = _apply_net(cur[name], *batch[name])
            np.testing.assert_array_equal(ts.relation_rows(name), cur[name])
        _stores_equal(js, ts)
    assert ts.stats.compactions > 0 and ts.stats.live_compactions > 0
    assert (ts.stats.compactions, ts.stats.live_compactions) == \
        (js.stats.compactions, js.stats.live_compactions)


def test_composite_compactions_count_the_hi_lo_regions(monkeypatch):
    """``stats.composite_compactions`` counts, of the compactions the store
    runs (a relation's live set or a stored projection), those of (hi, lo)
    regions: here the tri and quad live sets and the quad projection."""
    rng = np.random.default_rng(81)
    nv = 10
    seed = np.random.default_rng(77)
    cur = {"tri": np.unique(rows(seed, 80, 3, nv), axis=0),
           "quad": np.unique(rows(seed, 60, 4, nv), axis=0),
           "edge": np.unique(rows(seed, 40, 2, nv), axis=0)}
    ts = tdelta.RegionStore({k: v.copy() for k, v in cur.items()},
                            compact_ratio=0.4, device="cpu")
    ts.ensure("tri", (0, 1), 2)
    ts.ensure("quad", (0, 1, 2), 3)
    ts.ensure("edge", (0,), 1)
    seen = []  # composite or not, for each compaction _maybe_compact runs
    real = tdelta._compact_fold

    def spy(base, *args, **kw):
        if sys._getframe(1).f_code.co_name == "_maybe_compact":
            seen.append(base.lo is not None)
        return real(base, *args, **kw)

    monkeypatch.setattr(tdelta, "_compact_fold", spy)
    for _ in range(10):
        batch = {name: _dirty_batch(rng, nv, cur[name], 8, ar)
                 for name, ar in (("tri", 3), ("quad", 4), ("edge", 2))}
        out = ts.normalize({k: (u.copy(), w.copy())
                            for k, (u, w) in batch.items()})
        if any(a.size or b.size for a, b in out.values()):
            ts.begin_epoch(out)
            ts.commit(out)
        for name in cur:
            cur[name] = _apply_net(cur[name], *batch[name])
    st = ts.stats
    assert True in seen and False in seen
    assert st.compactions + st.live_compactions == len(seen)
    assert st.composite_compactions == sum(seen)


# ---------------------------------------------------------------------------
# §5.4 end to end through the session
# ---------------------------------------------------------------------------

def _edge_graph(seed, nv, n):
    rng = np.random.default_rng(seed)
    e = np.unique(rows(rng, n, 2, nv), axis=0)
    return e[e[:, 0] != e[:, 1]]


def _deltas_equal(td, jd):
    assert td.count_delta == jd.count_delta
    if jd.tuples is None:
        assert td.tuples is None
        return
    np.testing.assert_array_equal(td.tuples, jd.tuples)
    np.testing.assert_array_equal(td.weights, jd.weights)
    assert [(r.count, r.proposals, r.intersections, r.steps)
            for r in td.per_dq] == \
        [(r.count, r.proposals, r.intersections, r.steps)
         for r in jd.per_dq]


def _feed(delta, arity):
    if delta.tuples is None:
        return np.zeros((0, arity), np.int32), np.zeros(0, np.int32)
    return delta.tuples, delta.weights


def test_four_clique_tri_session_matches_jax_and_edge_plan(monkeypatch):
    """The JAX session runs its plain jnp paths (its own suites hold them
    bit-exact to its Pallas kernels), which compile in about half the time
    of the interpreted kernels over 20 epochs."""
    import functools
    import repro.api.session as jsession
    from repro.api import GraphSession as JSession
    from repro.core.bigjoin import BigJoinConfig as JConfig
    monkeypatch.setattr(jsession, "BigJoinConfig",
                        functools.partial(JConfig, use_kernel=False))
    monkeypatch.setattr(jdelta, "USE_MERGE_KERNEL", False)
    nv = 16
    e = _edge_graph(40, nv, 110)
    kw = dict(batch=128, out_capacity=1 << 14)
    js = JSession(e, local=True, **kw)
    ts = GraphSession(e, device="cpu", **kw)
    for s in (js, ts):
        tri = s.register("triangle")
        s.register("4-clique")
        tri0, _ = tri.enumerate()
        s.add_relation("tri", tri0)
        s.register("4-clique-tri")
    np.testing.assert_array_equal(ts.relation("tri"), js.relation("tri"))
    assert ts["4-clique-tri"].count() == ts["4-clique"].count() == \
        js["4-clique"].count()
    rng = np.random.default_rng(41)
    live = e
    for epoch in range(20):
        upd, w = _dirty_batch(rng, nv, live, 12, 2)
        jr1, tr1 = js.update(upd, w), ts.update(upd, w)
        for q in ("triangle", "4-clique"):
            _deltas_equal(tr1.deltas[q], jr1.deltas[q])
        feed = {"tri": _feed(tr1.deltas["triangle"], 3)}
        jr2, tr2 = js.update(feed), ts.update(feed)
        for rel in jr2.by_rel:
            for a, b in zip(tr2.by_rel[rel], jr2.by_rel[rel]):
                np.testing.assert_array_equal(a, b)
        _deltas_equal(tr2.deltas["4-clique-tri"], jr2.deltas["4-clique-tri"])
        a, b = tr1.deltas["4-clique"], tr2.deltas["4-clique-tri"]
        assert canon_signed(b.tuples, b.weights) == \
            canon_signed(a.tuples, a.weights), epoch
        live = tr1.advance(live)
        for rel in ("edge", "tri"):
            jl, tl = js.store._rels[rel], ts.store._rels[rel]
            for name in ("lb", "lc_ins", "lc_del"):
                same_index(getattr(tl, name), getattr(jl, name))
    np.testing.assert_array_equal(ts.relation("tri"), js.relation("tri"))
    assert ts.stats.live_compactions == js.stats.live_compactions
    c4, c4t = ts["4-clique"], ts["4-clique-tri"]
    assert c4t.net_change == c4.net_change == js["4-clique"].net_change
    # static re-evaluation off the maintained store: the derived tri
    # projections of the static plan
    assert c4t.count() == c4.count() == js["4-clique-tri"].count()
    assert any(r.derived for r in ts.store.projections.values())


def _joined(*deltas):
    """The signed union of several epochs' deltas, canonical."""
    t = [d.tuples for d in deltas if d.tuples is not None]
    w = [d.weights for d in deltas if d.weights is not None]
    if not t:
        return []
    return canon_signed(np.concatenate(t), np.concatenate(w))


def test_five_clique_quad_matches_five_clique_and_oracle(monkeypatch):
    """The edge epoch moves 5-clique-quad through its edge atom (quad
    old), the quad epoch through its quad atoms (edges new); each epoch's
    deltas, work counters, relation batches and live LSM regions equal the
    JAX session's (plain jnp paths, as above), and together the two
    epochs equal the edge-only 5-clique's delta and the oracle's."""
    import functools
    import repro.api.session as jsession
    from repro.api import GraphSession as JSession
    from repro.core.bigjoin import BigJoinConfig as JConfig
    monkeypatch.setattr(jsession, "BigJoinConfig",
                        functools.partial(JConfig, use_kernel=False))
    monkeypatch.setattr(jdelta, "USE_MERGE_KERNEL", False)
    nv = 11
    e = _edge_graph(50, nv, 70)
    kw = dict(batch=256, out_capacity=1 << 14)
    js = JSession(e, local=True, **kw)
    ts = GraphSession(e, device="cpu", **kw)
    for s in (js, ts):
        c4 = s.register("4-clique")
        s.register("5-clique")
        quad0, _ = c4.enumerate()
        s.add_relation("quad", quad0)
        s.register(FIVE_CLIQUE_QUAD)
    np.testing.assert_array_equal(ts.relation("quad"), js.relation("quad"))
    cq = ts["5-clique-quad"]
    assert cq.count() == ts["5-clique"].count() == js["5-clique"].count()
    rng = np.random.default_rng(51)
    live = e
    for epoch in range(6):
        upd, w = _dirty_batch(rng, nv, live, 10, 2)
        quad_before = ts.relation("quad")
        jr1, r1 = js.update(upd, w), ts.update(upd, w)
        for q in ("4-clique", "5-clique", "5-clique-quad"):
            _deltas_equal(r1.deltas[q], jr1.deltas[q])
        feed = {"quad": _feed(r1.deltas["4-clique"], 4)}
        jr2, r2 = js.update(feed), ts.update(feed)
        for rel in jr2.by_rel:
            for x, y in zip(r2.by_rel[rel], jr2.by_rel[rel]):
                np.testing.assert_array_equal(x, y)
        _deltas_equal(r2.deltas["5-clique-quad"], jr2.deltas["5-clique-quad"])
        a = r1.deltas["5-clique"]
        got = _joined(r1.deltas["5-clique-quad"], r2.deltas["5-clique-quad"])
        assert got == canon_signed(a.tuples, a.weights), epoch
        new = r1.advance(live)
        t, wt = tdelta.delta_oracle(
            cq.query, {"quad": quad_before, "edge": live},
            {"quad": ts.relation("quad"), "edge": new})
        assert got == canon_signed(t, wt)
        live = new
        for rel in ("edge", "quad"):
            jl, tl = js.store._rels[rel], ts.store._rels[rel]
            for name in ("lb", "lc_ins", "lc_del"):
                same_index(getattr(tl, name), getattr(jl, name))
    np.testing.assert_array_equal(ts.relation("quad"), js.relation("quad"))
    assert ts.stats.live_compactions == js.stats.live_compactions
    assert cq.count() == ts["5-clique"].count() == \
        js["5-clique-quad"].count()
    assert cq.net_change == ts["5-clique"].net_change == \
        js["5-clique-quad"].net_change


# ---------------------------------------------------------------------------
# relation and batch validation
# ---------------------------------------------------------------------------

def test_add_relation_validation():
    store = tdelta.RegionStore(np.array([[0, 1]], np.int32), device="cpu")
    with pytest.raises(ValueError, match="already exists"):
        store.add_relation("edge", np.zeros((0, 2), np.int32))
    with pytest.raises(ValueError, match="arity"):
        store.add_relation("penta", np.zeros((2, 5), np.int32))
    store.add_relation("tri", np.zeros((0, 3), np.int32), arity=3)
    assert store.arity_of("tri") == 3
    # a still-empty declaration may be re-seeded once, arity-checked
    with pytest.raises(ValueError, match="arity 3"):
        store.add_relation("tri", np.zeros((2, 4), np.int32))
    store.add_relation("tri", np.array([[1, 2, 3]], np.int32))
    assert store.num_tuples("tri") == 1
    with pytest.raises(ValueError, match="already exists"):
        store.add_relation("tri", np.array([[4, 5, 6]], np.int32))
    with pytest.raises(ValueError, match="arity=4"):
        store.add_relation("quad", np.zeros((4, 3), np.int32), arity=4)
    with pytest.raises(ValueError, match="2..4"):
        store.add_relation("lbl", np.array([[3], [5]], np.int32))


def test_bad_batches_raise():
    store = tdelta.RegionStore({"edge": np.array([[0, 1]], np.int32),
                                "tri": np.array([[1, 2, 3]], np.int32)},
                               device="cpu")
    tri = np.array([[1, 2, 3]], np.int32)
    with pytest.raises(ValueError, match="arity 3"):
        store.normalize({"tri": (np.zeros((2, 2), np.int32),
                                 np.ones(2, np.int32))})
    with pytest.raises(KeyError, match="unknown relation"):
        store.normalize({"quad": (np.zeros((1, 4), np.int32),
                                  np.ones(1, np.int32))})
    with pytest.raises(ValueError, match="their own weights"):
        store.normalize({"tri": tri}, -np.ones(1, np.int32))
    with pytest.raises(TypeError, match="integer"):
        store.normalize({"tri": (tri, -np.ones(1))})
    with pytest.raises(ValueError, match="negative id"):
        store.normalize({"tri": (-tri, np.ones(1, np.int32))})
    out = store.normalize({"tri": (tri, -np.ones(1, np.int32))})
    assert out["tri"][1].shape[0] == 1  # a real delete, not a +1 no-op


def test_register_declares_then_seeds_relation():
    e = np.array([[0, 1], [1, 2], [0, 2], [0, 3], [1, 3], [2, 3]], np.int32)
    sess = GraphSession(e, device="cpu", batch=128, out_capacity=1 << 12)
    h = sess.register("4-clique-tri")
    assert sess.num_tuples("tri") == 0 and h.count() == 0
    tri0, _ = sess.register("triangle").enumerate()
    sess.add_relation("tri", tri0)  # re-seeds the empty declaration
    assert h.count() == sess.register("4-clique").count() == 1
