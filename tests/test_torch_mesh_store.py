"""The mesh's sharded store in the port (``RegionStore(shard_w=w)``, the
plain versions on the CPU) against the JAX package's, in process: the JAX
sharded store keeps its [w] worker axis on one device, as its own suites
run it (``tests/test_region_store.py``, ``tests/test_nary_store.py``).

Held equal: the sharded packed builders leaf for leaf; the sharded commit
fold's plain version against the JAX fold kernel's ``grid=(w,)`` form in
interpret mode, 1-word and composite, with one worker's delta empty; a
stream of the ``edge`` and ``tri`` relations with compactions, every
normalize output and every snapshot leaf after each epoch; the sharded
coverage keys; sharded snapshots restored across the packages; and
``deal_seed`` and ``auto_sizing`` over the workers.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import delta as jdelta
from repro_torch.core import csr, delta
from repro_torch.core.csr import IndexData

W = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions at these sizes run faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch(d) -> IndexData:
    return IndexData(*(torch.from_numpy(np.array(x)) for x in
                       (d.key, d.val, d.n)),
                     None if d.lo is None else torch.from_numpy(
                         np.array(d.lo)))


def same_index(t: IndexData, j) -> None:
    for part in ("key", "val", "n", "lo"):
        a, b = getattr(t, part), getattr(j, part)
        if b is None:
            assert a is None, part
            continue
        a, b = a.numpy(), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), part
        np.testing.assert_array_equal(a, b, err_msg=part)


def rows(rng, n, arity, nv):
    return rng.integers(0, nv, (n, arity)).astype(np.int32)


@pytest.mark.parametrize("arity", [2, 3])
@pytest.mark.parametrize("w", W)
def test_sharded_packed_builders_match_jax(w, arity):
    rng = np.random.default_rng(w * 10 + arity)
    r = np.unique(rows(rng, 300, arity, 60), axis=0)
    for cap in (None, 512):
        got = delta._packed_index(r, "cpu", arity, capacity=cap, shard_w=w)
        same_index(got, jdelta._packed_index(r, w, arity, capacity=cap))
    same_index(delta._empty_packed("cpu", arity, w),
               jdelta._empty_packed(w, arity))
    # ownership: every row on one worker, the shards' counts summing up
    assert int(got.n.sum()) == r.shape[0]


def _fold_regions(rng, w, arity, nv, skip):
    """A sharded (base, cins, cdel, uins, udel) under the store's
    invariants (cdel ⊆ base, cins ∩ base = ∅, uins outside the live set,
    udel inside it), with worker ``skip`` given no delta row."""
    allr = np.unique(rows(rng, 900, arity, nv), axis=0)
    allr = allr[rng.permutation(allr.shape[0])]
    base, cins, fresh = allr[:400], allr[400:480], allr[480:600]
    cdel = base[:60]
    live = np.concatenate([base[60:], cins])
    udel = live[rng.choice(live.shape[0], 70, replace=False)]
    uins = np.concatenate([fresh[:50], cdel[:10]])  # re-inserts too

    def owner(r):
        hi, lo = delta._pack_rows(r, arity)
        return csr.shard_of((hi, lo) if arity > 2 else hi, w)
    uins, udel = uins[owner(uins) != skip], udel[owner(udel) != skip]
    out = []
    for r, cap in ((base, 512), (cins, 128), (cdel, 128), (uins, 256),
                   (udel, 256)):
        out.append(jdelta._packed_index(r, w, arity, capacity=cap))
    return out


@pytest.mark.parametrize("arity", [2, 3], ids=["1-word", "composite"])
def test_sharded_fold_plain_matches_jax_kernel(arity):
    """``commit_fold(..., sharded=True)`` on CPU tensors (a worker at a
    time, stacked) against the JAX fold's ``grid=(w,)`` kernel in
    interpret mode; worker 1's delta is empty."""
    from repro_torch.kernels.merge.fold import commit_fold
    w = 4
    rng = np.random.default_rng(arity)
    jb, jci, jcd, jui, jud = _fold_regions(rng, w, arity, 200, skip=1)
    want = jdelta._commit_fold_impl(jb, jci, jcd, jui, jud, cins_cap=512,
                                    cdel_cap=512, sharded=True,
                                    use_kernel=True)
    b, ci, cd, ui, ud = map(to_torch, (jb, jci, jcd, jui, jud))
    assert int(ui.n[1]) == int(ud.n[1]) == 0
    got = commit_fold(ci, cd, ui, ud, base=b, cins_cap=512, cdel_cap=512,
                      sharded=True)
    for g, x in zip(got, want):
        same_index(g, x)
    with pytest.raises(ValueError, match="in_ba"):
        commit_fold(ci, cd, ui, ud, torch.zeros((w, 256), dtype=torch.int32),
                    cins_cap=512, cdel_cap=512, sharded=True)


def _plans():
    from repro_torch.core import query as Q
    from repro_torch.core.plan import make_delta_plan
    from repro.core import query as JQ
    from repro.core.plan import make_delta_plan as jmake
    out = []
    for name in ("triangle", "4-clique-tri"):
        out.append(([make_delta_plan(d) for d in
                     Q.delta_queries(Q.query_by_name(name))],
                    [jmake(d) for d in
                     JQ.delta_queries(JQ.query_by_name(name))]))
    return out


def snaps_equal(a, b) -> None:
    (la, ma), (lb, mb) = a, b
    assert ma["names"] == mb["names"]
    for name, x, y in zip(ma["names"], la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert json.loads(json.dumps(ma)) == json.loads(json.dumps(mb))


def _stores(w, seed, monkeypatch):
    """A port and a JAX sharded store over the same edge and tri rows,
    the triangle and 4-clique-tri delta plans' projections ensured."""
    monkeypatch.setattr(jdelta, "USE_MERGE_KERNEL", False)
    rng = np.random.default_rng(seed)
    nv = 16
    edges = np.unique(rows(rng, 90, 2, nv), axis=0)
    edges = edges[edges[:, 0] != edges[:, 1]]
    tri = np.unique(rows(rng, 80, 3, nv), axis=0)
    tri = tri[~delta._degenerate_rows(tri)]
    init = {"edge": edges, "tri": tri}
    ts = delta.RegionStore(init, shard_w=w, compact_ratio=0.3, device="cpu")
    js = jdelta.RegionStore(init, shard_w=w, compact_ratio=0.3)
    for tplans, jplans in _plans():
        for tp, jp in zip(tplans, jplans):
            ts.ensure_plan(tp)
            js.ensure_plan(jp)
    return ts, js, rng, nv


def _epoch(ts, js, rng, nv):
    from tests.test_torch_nary import _dirty_batch
    batch = {}
    for rel, ar in (("edge", 2), ("tri", 3)):
        batch[rel] = _dirty_batch(rng, nv, ts.relation_rows(rel), 12, ar)
    tn, jn = ts.normalize(batch), js.normalize(batch)
    for rel in batch:
        for a, b in zip(tn[rel], jn[rel]):
            np.testing.assert_array_equal(a, b)
    for s, n in ((ts, tn), (js, jn)):
        s.begin_epoch(n)
        s.commit(n)


@pytest.mark.parametrize("w", W)
def test_sharded_store_stream_matches_jax(w, monkeypatch):
    ts, js, rng, nv = _stores(w, w, monkeypatch)
    snaps_equal(ts.snapshot(), js.snapshot())
    for _ in range(6):
        _epoch(ts, js, rng, nv)
        snaps_equal(ts.snapshot(), js.snapshot())
    assert ts.stats.compactions > 0 and ts.stats.live_compactions > 0
    assert ts.stats.compactions == js.stats.compactions
    for rel in ("edge", "tri"):
        np.testing.assert_array_equal(ts.relation_rows(rel),
                                      js.relation_rows(rel))
        assert ts.num_tuples(rel) == js.num_tuples(rel)
    # every shard entry owned once: the shards' live entries sum to the
    # relation's rows, a projection's to its entries
    for reg in ts.projections.values():
        if not reg.derived:
            assert int(reg.d_base.n.sum() + reg.d_cins.n.sum()
                       - reg.d_cdel.n.sum()) == ts.num_tuples(reg.rel)


# the keys of the JAX store's ``kernel_coverage`` (reference
# ``core/delta.py:1334-1340``); calling it traces through ``jax.core``
# names this JAX no longer has (ROADMAP Queue 3)
COVERAGE_KEYS = {"composite", "key_dtype", "fold_pallas_calls",
                 "fused_fold", "probe_pallas_calls"}


def test_sharded_coverage_keys_match_jax(monkeypatch):
    ts, js, _, _ = _stores(4, 7, monkeypatch)
    got = ts.kernel_coverage(64)
    assert sorted(got) == sorted(js.relations)
    for rel in got:
        assert set(got[rel]) == COVERAGE_KEYS
        lb = js._rels[rel].lb
        assert got[rel]["composite"] == (lb.lo is not None)
        assert got[rel]["key_dtype"] == str(lb.key.dtype)
        # on the CPU the plain versions run: no launch to count
        assert got[rel]["fold_pallas_calls"] == 0
        assert got[rel]["probe_pallas_calls"] == 0


def test_sharded_snapshot_crosses_packages(monkeypatch):
    w = 4
    ts, js, rng, nv = _stores(w, 11, monkeypatch)
    for _ in range(3):
        _epoch(ts, js, rng, nv)
    # JAX -> port and port -> JAX, into stores of other graphs
    small = {"edge": np.array([[0, 1]], np.int32),
             "tri": np.array([[0, 1, 2]], np.int32)}
    # (restore keeps the store's own compact_ratio, as the JAX one does)
    t2 = delta.RegionStore(small, shard_w=w, compact_ratio=0.3,
                           device="cpu")
    t2.restore(*js.snapshot())
    j2 = jdelta.RegionStore(small, shard_w=w, compact_ratio=0.3)
    j2.restore(*ts.snapshot())
    snaps_equal(t2.snapshot(), js.snapshot())
    snaps_equal(j2.snapshot(), ts.snapshot())
    # and they stream on in lockstep
    state = rng.bit_generator.state
    _epoch(t2, j2, rng, nv)
    rng.bit_generator.state = state
    _epoch(ts, js, rng, nv)
    snaps_equal(t2.snapshot(), ts.snapshot())
    # a mesh-width mismatch raises with the JAX store's message
    t4 = delta.RegionStore(small, shard_w=2, device="cpu")
    with pytest.raises(ValueError, match="shard_w=4 store; this store "
                       "has shard_w=2"):
        t4.restore(*ts.snapshot())
    t0 = delta.RegionStore(small, device="cpu")
    with pytest.raises(ValueError, match="same mesh width"):
        t0.restore(*ts.snapshot())


@pytest.mark.parametrize("floor", [0, 512])
def test_deal_seed_matches_jax(floor):
    from repro.core.distributed import deal_seed as jdeal
    from repro_torch.core.distributed import deal_seed
    rng = np.random.default_rng(floor)
    for n, width, w in ((0, 2, 4), (7, 2, 4), (301, 3, 4), (130, 2, 2)):
        seed = rows(rng, n, width, 50)
        wts = rng.choice(np.array([-1, 1], np.int32), n)
        for a, b in zip(deal_seed(seed, wts, w, width, floor),
                        jdeal(seed, wts, w, width, floor)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_auto_sizing_over_workers_matches_jax(w):
    from repro.api import auto_sizing as jsizing
    from repro.core.query import query_by_name as jq
    from repro_torch.api import auto_sizing
    from repro_torch.core.query import query_by_name as tq
    for name in ("triangle", "diamond", "4-clique", "4-clique-tri"):
        for ne in (10, 5000, 10 ** 7):
            for ub in (64, 2048):
                got = auto_sizing(tq(name), ne, w, ub)
                want = jsizing(jq(name), ne, w, ub)
                assert (got.batch, got.out_capacity,
                        got.route_capacity) == \
                    (want.batch, want.out_capacity, want.route_capacity)
