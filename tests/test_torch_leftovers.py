"""The main path's leftover modules in the port (plain versions on the
CPU) against the JAX package, exact: the public folds of ``csr`` (1-word
and composite, at a capacity below the union too), ``index_count`` /
``index_kth`` / ``capacity_ladder``, the binary-join and triangle-count
baselines, the §5.4 transformations with both engines, and
``clean_update_batches`` batch for batch."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import csr as jcsr
from repro.core import generic_join as jgj
from repro.core import optimizations as jopt
from repro.core import query as JQ
from repro.core.csr import Graph as JGraph
from repro.data import synthetic as jsyn
from repro_torch.core import csr as tcsr
from repro_torch.core import generic_join as tgj
from repro_torch.core import optimizations as topt
from repro_torch.core import query as TQ
from repro_torch.core.csr import Graph
from repro_torch.data import synthetic as tsyn

from tests.test_torch_csr import pair, same, same_index
from tests.test_torch_nary import comp_pair

# 1-word keys (int32, int64), then composite (hi, lo) keys of 3 columns
# (narrow or wide hi word) and of 4
LAYOUTS = [(1, True), (1, False), (3, True), (3, False), (4, False)]
LAYOUT_IDS = ["i32", "i64", "lex3-i32", "lex3-i64", "lex4"]
FOLDS = ["merge_index", "diff_index", "intersect_index"]


def _pair(rng, k, narrow):
    if k == 1:
        return pair(rng, int(rng.integers(120, 200)), narrow, nv=20)
    return comp_pair(rng, int(rng.integers(120, 200)), k, narrow, nv=4)


@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("k,narrow", LAYOUTS, ids=LAYOUT_IDS)
def test_public_folds_match(fold, k, narrow):
    """Each fold at a capacity that holds its result and at 128, below
    the union (entries past the capacity drop, the count does not)."""
    rng = np.random.default_rng(7 + k + 10 * narrow + 100 * FOLDS.index(fold))
    ja, ta = _pair(rng, k, narrow)
    jb, tb = _pair(rng, k, narrow)
    union = int(tcsr.merge_index(ta, tb, ta.capacity + tb.capacity).n)
    assert union > 128 and int(ta.n) > 0 and int(tb.n) > 0
    for cap in (tcsr.round_capacity(ta.capacity + tb.capacity), 128):
        got = getattr(tcsr, fold)(ta, tb, cap)
        want = getattr(jcsr, fold)(ja, jb, cap)
        same_index(got, want)
        assert (got.lo is None) == (k == 1)
        if got.lo is not None:
            same(got.lo, want.lo)


@pytest.mark.parametrize("k,narrow", LAYOUTS, ids=LAYOUT_IDS)
def test_index_count_and_kth_match(k, narrow):
    rng = np.random.default_rng(50 + k)
    j, t = _pair(rng, k, narrow)
    B = 300
    if k == 1:
        q = rng.integers(0, 22, B).astype(np.int32 if narrow else np.int64)
        jq, tq = jnp.asarray(q), torch.from_numpy(q)
    else:
        cols = rng.integers(0, 5, (B, k)).astype(np.int32)
        jq = tuple(jnp.asarray(np.asarray(x))
                   for x in jcsr.pack_key(tuple(cols.T)))
        tq = tcsr.pack_key(tuple(torch.from_numpy(c) for c in cols.T))
        if narrow:
            jq = (jq[0].astype(jnp.int32), jq[1])
            tq = (tq[0].to(torch.int32), tq[1])
    cnt = tcsr.index_count(t, tq)
    same(cnt, jcsr.index_count(j, jq))
    start, _ = tcsr.index_range(t, tq)
    kk = rng.integers(0, 4, B).astype(np.int32)
    kk[:5] = t.capacity  # past the capacity: clamped to the last slot
    same(tcsr.index_kth(t, start, torch.from_numpy(kk)),
         jcsr.index_kth(j, jnp.asarray(start.numpy()), jnp.asarray(kk)))


@pytest.mark.parametrize("lo,hi", [(1, 1), (0, 128), (100, 5000),
                                   (129, 129), (3000, 10), (1, 1 << 20)])
def test_capacity_ladder_matches(lo, hi):
    assert tcsr.capacity_ladder(lo, hi) == jcsr.capacity_ladder(lo, hi)


def _graphs(nv, ne, seed):
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, nv, ne), rng.integers(0, nv, ne)
    keep = u != v
    e = np.stack([u[keep], v[keep]], 1).astype(np.int32)
    return JGraph.from_edges(e, nv), Graph.from_edges(e, nv)


@pytest.mark.parametrize("name", ["triangle", "diamond", "4-clique",
                                  "house"])
def test_binary_join_matches(name):
    jg, tg = _graphs(40, 300, 3)
    jq = JQ.query_by_name(name)
    tq = TQ.query_by_name(name)
    out, cnt, peak = tgj.binary_join(tq, {TQ.EDGE: tg.edges})
    jout, jcnt, jpeak = jgj.binary_join(jq, {JQ.EDGE: jg.edges})
    np.testing.assert_array_equal(out, jout)
    assert (cnt, peak) == (jcnt, jpeak)
    gj, gcnt = tgj.generic_join(tq, {TQ.EDGE: tg.edges})
    assert cnt == gcnt
    np.testing.assert_array_equal(out, np.unique(gj, axis=0))
    with pytest.raises(tgj.IntermediateBlowup) as te:
        tgj.binary_join(tq, {TQ.EDGE: tg.edges}, max_intermediate=50)
    with pytest.raises(jgj.IntermediateBlowup) as je:
        jgj.binary_join(jq, {JQ.EDGE: jg.edges}, max_intermediate=50)
    assert str(te.value) == str(je.value)
    assert issubclass(tgj.IntermediateBlowup, RuntimeError)


@pytest.mark.parametrize("seed", range(3))
def test_fast_triangle_count_matches(seed):
    _, tg = _graphs(60, 700, seed)
    got = tgj.fast_triangle_count(tg.edges)
    assert got == jgj.fast_triangle_count(tg.edges)
    und = tg.undirected()
    assert 6 * got == tgj.generic_join(TQ.triangle(),
                                       {TQ.EDGE: und.edges})[1]
    assert tgj.fast_triangle_count(np.zeros((0, 2), np.int32)) == 0


@pytest.mark.parametrize("seed", range(2))
def test_symmetry_break_and_house_match(seed):
    jg, tg = _graphs(45, 600, 4 + seed)
    js, ts = jopt.symmetry_break(jg), topt.symmetry_break(tg)
    np.testing.assert_array_equal(ts.edges, js.edges)
    assert ts.num_vertices == js.num_vertices
    flat = tgj.generic_join(TQ.house(symmetric=True), {TQ.EDGE: ts.edges})[1]
    assert topt.factorized_house_count(ts) == \
        jopt.factorized_house_count(js) == flat


@pytest.mark.parametrize("engine", ["bigjoin", "oracle"])
def test_triangle_relation_and_four_clique_via_tri_match(engine):
    """Both engines of the port against the JAX package's host oracle:
    the tri rows, and 4-cliques through tri equal to the flat symmetric
    4-clique count."""
    jg, tg = _graphs(55, 650, 2)
    js, ts = jopt.symmetry_break(jg), topt.symmetry_break(tg)
    kw = {"device": "cpu"} if engine == "bigjoin" else {}
    tri = topt.build_triangle_relation(ts, engine, **kw)
    jtri = jopt.build_triangle_relation(js, "oracle")
    np.testing.assert_array_equal(np.unique(tri, axis=0),
                                  np.unique(jtri, axis=0))
    cnt, rows = topt.four_clique_via_tri(ts, engine, **kw)
    jcnt, jrows = jopt.four_clique_via_tri(js, "oracle")
    flat = tgj.generic_join(TQ.four_clique(symmetric=True),
                            {TQ.EDGE: ts.edges})[1]
    assert cnt == jcnt == flat > 0
    np.testing.assert_array_equal(np.unique(rows, axis=0),
                                  np.unique(jrows, axis=0))


@pytest.mark.parametrize("seed,batch", [(0, 64), (3, 33)])
def test_clean_update_batches_match(seed, batch):
    edges = tsyn.rmat_graph(7, 4, seed=seed)
    got = tsyn.clean_update_batches(edges, 128, batch, 5, seed=seed)
    want = jsyn.clean_update_batches(edges, 128, batch, 5, seed=seed)
    assert len(got) == len(want) == 5
    for (r, w), (jr, jw) in zip(got, want):
        assert (r.dtype, w.dtype) == (jr.dtype, jw.dtype)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(w, jw)


def test_bigjoin_engine_defaults_to_the_card():
    """``engine="bigjoin"`` with no device takes the card, as every entry
    point does, and raises where CUDA is absent."""
    _, tg = _graphs(20, 60, 0)
    g = topt.symmetry_break(tg)
    for fn in (topt.build_triangle_relation, topt.four_clique_via_tri):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn(g, "bigjoin")
            continue
        got, want = fn(g, "bigjoin"), fn(g, "oracle")
        if isinstance(got, tuple):  # (count, rows): the counts
            got, want = got[0], want[0]
        else:
            got, want = np.unique(got, axis=0), np.unique(want, axis=0)
        np.testing.assert_array_equal(got, want)
