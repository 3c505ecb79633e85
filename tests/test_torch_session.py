"""The streaming session of the port (plain versions on the CPU) against
``repro.api.GraphSession`` epoch for epoch: normalized batches, every
query's signed delta (tuples in order, weights, work counters), and every
projection's and the live set's base/cins/cdel regions including their
sentinel padding — over dirty update batches with compaction forced."""
import numpy as np
import pytest
import torch

from repro.api import GraphSession as JSession
from repro.data import synthetic as jsyn
from repro_torch.api import GraphSession, canon_signed
from repro_torch.core.delta import delta_oracle
from repro_torch.data import synthetic as tsyn

from tests.test_torch_csr import same_index

QUERIES = ("triangle", "diamond", "4-clique")


def test_synthetic_generators_match():
    np.testing.assert_array_equal(jsyn.rmat_graph(9, 4, seed=3),
                                  tsyn.rmat_graph(9, 4, seed=3))
    live = tsyn.rmat_graph(7, 4, seed=1)
    for step in range(3):
        a = jsyn.EdgeUpdateStream(128, 64, seed=2).batch_at(step, live)
        b = tsyn.EdgeUpdateStream(128, 64, seed=2).batch_at(step, live)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _regions_equal(jstore, tstore):
    assert set(jstore.projections) == set(tstore.projections)
    for proj, jr in jstore.projections.items():
        tr = tstore.projections[proj]
        for name in ("base", "cins", "cdel"):
            same_index(getattr(tr, "d_" + name), getattr(jr, "d_" + name))
        assert (tr.n_base, tr.n_cins, tr.n_cdel) == \
            (jr.n_base, jr.n_cins, jr.n_cdel)
    jl, tl = jstore._rels["edge"], tstore._rels["edge"]
    for name in ("lb", "lc_ins", "lc_del"):
        same_index(getattr(tl, name), getattr(jl, name))
    assert list(tl.n_live) == [int(x) for x in jl.n_live]


def test_session_matches_jax_epoch_for_epoch():
    edges = tsyn.rmat_graph(6, 5, seed=4)
    kw = dict(batch=128, out_capacity=1 << 14, compact_ratio=0.08)
    js = JSession(edges, local=True, **kw)
    ts = GraphSession(edges, device="cpu", **kw)
    for q in QUERIES:
        js.register(q)
        ts.register(q)
    # deletes outweigh inserts so the base stays on its first capacity rung
    # (the JAX side compiles every dataflow once per rung)
    stream = tsyn.EdgeUpdateStream(64, 48, insert_frac=0.4, seed=9)
    live = edges
    for epoch in range(8):
        upd, w = stream.batch_at(epoch, live)
        jr, tr = js.update(upd, w), ts.update(upd, w)
        np.testing.assert_array_equal(tr.ins, jr.ins)
        np.testing.assert_array_equal(tr.dels, jr.dels)
        for q in QUERIES:
            jd, td = jr.deltas[q], tr.deltas[q]
            assert td.count_delta == jd.count_delta
            if jd.tuples is None:
                assert td.tuples is None
            else:
                np.testing.assert_array_equal(td.tuples, jd.tuples)
                np.testing.assert_array_equal(td.weights, jd.weights)
            assert [(r.count, r.proposals, r.intersections, r.steps)
                    for r in td.per_dq] == \
                [(r.count, r.proposals, r.intersections, r.steps)
                 for r in jd.per_dq]
        _regions_equal(js.store, ts.store)
        live = tr.advance(live)
    st, jst = ts.stats, js.stats
    assert st.compactions > 0 and st.live_compactions > 0
    assert (st.compactions, st.live_compactions, st.commit_calls,
            st.normalize_calls) == (jst.compactions, jst.live_compactions,
                                    jst.commit_calls, jst.normalize_calls)
    np.testing.assert_array_equal(ts.edges, js.edges)
    np.testing.assert_array_equal(ts.edges, live)
    for q in QUERIES:
        assert ts[q].count() == js[q].count()
        assert ts[q].net_change == js[q].net_change


def test_session_matches_oracle_and_handles():
    edges = tsyn.rmat_graph(5, 4, seed=7)
    ts = GraphSession(edges, device="cpu", batch=64, out_capacity=1 << 13,
                      compact_ratio=0.2)
    tri = ts.register("triangle")
    seen = []
    tri.subscribe(lambda epoch, res: seen.append((epoch, res.count_delta)))
    stream = tsyn.EdgeUpdateStream(32, 24, seed=1)
    live = edges
    for epoch in range(3):
        upd, w = stream.batch_at(epoch, live)
        res = ts.update(upd, w)
        new = res.advance(live)
        t, wt = delta_oracle(tri.query, live, new)
        d = res.deltas["triangle"]
        assert canon_signed(d.tuples, d.weights) == canon_signed(t, wt)
        live = new
    assert [e for e, _ in seen] == [1, 2, 3]
    assert tri.count() == tri.enumerate()[0].shape[0]
    # an all no-op batch (inserts of live edges) is an exact no-op epoch
    res = ts.update(live[:4], np.ones(4, np.int32))
    assert res.is_noop and ts.epoch == 4


@pytest.mark.parametrize("sorted_live", [True, False])
def test_epoch_advance_matches_set_algebra(sorted_live):
    from repro_torch.api import EpochResult
    rng = np.random.default_rng(5)
    live = np.unique(rng.integers(0, 40, (300, 2)).astype(np.int32), axis=0)
    if not sorted_live:
        live = live[::-1]
    dels = live[rng.integers(0, live.shape[0], 30)]
    ins = rng.integers(0, 40, (50, 2)).astype(np.int32)
    res = EpochResult(1, ins, dels, {})
    want = np.unique(np.concatenate(
        [live[~(live[:, None] == np.unique(dels, axis=0)[None]).all(-1)
              .any(1)], ins]), axis=0)
    got = res.advance(live)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        EpochResult(1, ins, dels[:0], {}).advance(live[:0]),
        np.unique(ins, axis=0))


def test_single_query_engine_apply_matches_oracle():
    from repro_torch.core.delta import DeltaBigJoin
    from repro_torch.core.bigjoin import BigJoinConfig
    from repro_torch.core.query import query_by_name
    edges = tsyn.rmat_graph(5, 4, seed=3)
    q = query_by_name("diamond")
    eng = DeltaBigJoin(q, edges, cfg=BigJoinConfig(batch=64, seed_chunk=64,
                                                   out_capacity=1 << 13),
                       compact_ratio=0.1, device="cpu")
    stream = tsyn.EdgeUpdateStream(32, 24, seed=4)
    live = edges
    for epoch in range(2):
        upd, w = stream.batch_at(epoch, live)
        res = eng.apply(upd, w)
        new = eng.store.edges
        t, wt = delta_oracle(q, live, new)
        assert canon_signed(res.tuples, res.weights) == canon_signed(t, wt)
        live = new


@pytest.mark.parametrize("name", QUERIES)
@pytest.mark.parametrize("num_edges", [10, 5000, 10**7])
def test_auto_sizing_matches_jax(name, num_edges):
    from repro.api import auto_sizing as j_auto_sizing
    from repro.core.query import query_by_name as jq
    from repro_torch.api import auto_sizing
    from repro_torch.core.query import query_by_name as tq
    got, want = auto_sizing(tq(name), num_edges), \
        j_auto_sizing(jq(name), num_edges)
    assert (got.batch, got.out_capacity, got.route_capacity) == \
        (want.batch, want.out_capacity, want.route_capacity)


def test_session_device_and_mesh_guards():
    """``local=False`` without a mesh is four workers on the session's
    device; a mesh on another device is refused."""
    from repro_torch.launch.mesh import make_host_mesh
    edges = tsyn.rmat_graph(4, 2, seed=0)
    s = GraphSession(edges, device="cpu", local=False)
    assert (s.local, s.w, s.store.shard_w) == (False, 4, 4)
    assert GraphSession(edges, device="cpu").local
    with pytest.raises(ValueError, match="device"):
        GraphSession(edges, device="cpu", mesh=make_host_mesh(2, "meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            GraphSession(edges)


def _entry_points():
    from repro_torch.core import bigjoin, csr, delta, plan, query
    edges = tsyn.rmat_graph(4, 2, seed=0)
    tri = query.query_by_name("triangle")
    return {
        "session": lambda **kw: GraphSession(edges, **kw),
        "region_store": lambda **kw: delta.RegionStore(edges, **kw),
        "delta_bigjoin": lambda **kw: delta.DeltaBigJoin(tri, edges, **kw),
        "build_indices": lambda **kw: bigjoin.build_indices(
            plan.make_plan(tri), {"edge": edges}, **kw),
        "build_index": lambda **kw: csr.build_index(edges, (0,), 1, **kw),
        "empty_index": lambda **kw: csr.empty_index(8, **kw),
    }


def _device_types(out):
    if isinstance(out, dict):  # build_indices
        return {vi.pos[0].key.device.type for vi in out.values()}
    out = getattr(out, "store", out)  # a session or an engine
    types = {t.device.type for t in vars(out).values()
             if isinstance(t, torch.Tensor)}
    if getattr(out, "device", None) is not None:
        types.add(torch.device(out.device).type)
    return types


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_entry_points_default_to_the_card(entry):
    """Every entry point runs on the card unless the caller asks for the
    CPU: with no device it takes the card, or raises where CUDA is absent;
    an explicit ``device="cpu"`` keeps its state on the host."""
    make = _entry_points()[entry]
    if torch.cuda.is_available():
        assert _device_types(make()) == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert _device_types(make(device="cpu")) == {"cpu"}
