"""Session snapshots in the port (plain versions on the CPU) against the
JAX package: after epochs that include compactions the port's snapshot
equals the JAX one leaf for leaf (names, dtypes, shapes, values) and meta
for meta, for the edge relation and for a ``tri`` session with a derived
projection; a snapshot saved by either package's checkpoint restores into
the other's session, which then runs on in lockstep with the source; and
the error paths."""
import copy
import functools
import json

import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro.api import GraphSession as JSession
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import delta as jdelta
from repro_torch import faults
from repro_torch.api import GraphSession
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import synthetic as tsyn
from repro_torch.errors import SnapshotError

from tests.test_torch_nary import _deltas_equal, _dirty_batch, _feed

KW = dict(batch=128, out_capacity=1 << 14, compact_ratio=0.08)
QUERIES = ("triangle",)


@pytest.fixture(autouse=True)
def _jax_plain(monkeypatch):
    """The JAX session on its plain jnp paths (its own suites hold them
    bit-exact to its Pallas kernels): one compile per dataflow, fast."""
    import repro.api.session as jsession
    from repro.core.bigjoin import BigJoinConfig as JConfig
    monkeypatch.setattr(jsession, "BigJoinConfig",
                        functools.partial(JConfig, use_kernel=False))
    monkeypatch.setattr(jdelta, "USE_MERGE_KERNEL", False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def snaps_equal(a, b, stats=True):
    """Two snapshots equal leaf for leaf (names, dtypes, shapes, values)
    and meta for meta once through JSON (as a checkpoint stores it)."""
    (la, ma), (lb, mb) = a, b
    assert ma["names"] == mb["names"]
    assert len(la) == len(lb) == len(ma["names"])
    for name, x, y in zip(ma["names"], la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), name
        np.testing.assert_array_equal(x, y, err_msg=name)
    ja, jb = json.loads(json.dumps(ma)), json.loads(json.dumps(mb))
    if not stats:
        ja.pop("stats")
        jb.pop("stats")
    assert ja == jb


def _edge_pair(n=None):
    edges = tsyn.rmat_graph(6, 5, seed=4)
    init = edges if n is None else edges[:n]
    js = JSession(init, local=True, **KW)
    ts = GraphSession(init, device="cpu", **KW)
    for s in (js, ts):
        for q in QUERIES:
            s.register(q)
    return edges, js, ts


def _run(sessions, stream, live, epochs, start=0):
    """Epochs in lockstep: every session's deltas equal the first's."""
    for epoch in range(start, start + epochs):
        upd, w = stream.batch_at(epoch, live)
        res = [s.update(upd, w) for s in sessions]
        for r in res[1:]:
            for q in QUERIES:
                _deltas_equal(r.deltas[q], res[0].deltas[q])
        live = res[0].advance(live)
    return live


def _stream():
    # deletes outweigh inserts so the base stays on its first rung
    return tsyn.EdgeUpdateStream(64, 48, insert_frac=0.4, seed=9)


def test_edge_snapshot_matches_jax_leaf_for_leaf():
    edges, js, ts = _edge_pair()
    _run((js, ts), _stream(), edges, 4)
    assert ts.stats.compactions > 0 and ts.stats.live_compactions > 0
    tl, tm = ts.snapshot()
    snaps_equal(js.snapshot(), (tl, tm))
    n = [x for name, x in zip(tm["names"], tl) if name.endswith(".n")]
    assert n and all(x.dtype == np.int32 and x.shape == () for x in n)
    sess = tm["session"]
    assert (sess["epoch"], sess["w"], sess["local"]) == (4, 1, True)
    assert {q: h["net_change"] for q, h in sess["handles"].items()} == \
        {q: ts[q].net_change for q in QUERIES}


@pytest.mark.parametrize("src", ["jax", "port"])
def test_snapshot_restores_across_packages(src, tmp_path):
    """A snapshot saved with one package's checkpoint, read back with the
    other's ``restore_latest_raw``, restores into a session of the other
    package built over a few edges only; source and restored sessions
    then run 3 epochs in lockstep, deltas exact, and end equal."""
    edges, js, ts = _edge_pair()
    stream = _stream()
    live = _run((js, ts), stream, edges, 3)
    source = js if src == "jax" else ts
    save = JCheckpointManager if src == "jax" else CheckpointManager
    load = CheckpointManager if src == "jax" else JCheckpointManager
    leaves, meta = source.snapshot()
    save(str(tmp_path)).save(leaves, 3, extra=meta)
    got, manifest = load(str(tmp_path)).restore_latest_raw()
    _, jb, tb = _edge_pair(16)
    target = tb if src == "jax" else jb
    target.restore(got, manifest["extra"])
    assert target.epoch == 3
    if target is tb:  # restored tensors on the store's device
        for st in tb.store._rels.values():
            for idx in (st.lb, st.lc_ins, st.lc_del):
                assert isinstance(idx.key, torch.Tensor)
                assert idx.key.device == tb.device
    for q in QUERIES:
        assert target[q].net_change == source[q].net_change
    snaps_equal(source.snapshot(), target.snapshot())
    _run((source, target), stream, live, 3, start=3)
    snaps_equal(source.snapshot(), target.snapshot(), stats=False)
    for q in QUERIES:
        assert target[q].net_change == source[q].net_change
        assert target[q].count() == source[q].count()


def test_tri_snapshot_matches_jax_with_derived_projection():
    """A ``tri`` session (composite ``lo`` leaves) with a derived projection
    after compactions; in its last
    epoch a schedule that never fires: both packages count the same fold
    hits with the derived projection present."""
    rng = np.random.default_rng(41)
    nv = 16
    e = np.unique(rng.integers(0, nv, (110, 2)).astype(np.int32), axis=0)
    e = e[e[:, 0] != e[:, 1]]
    kw = dict(batch=128, out_capacity=1 << 14, compact_ratio=0.1)
    js = JSession(e, local=True, **kw)
    ts = GraphSession(e, device="cpu", **kw)
    tri0, _ = ts.register("triangle").enumerate()
    js.register("triangle")
    for s in (js, ts):
        s.add_relation("tri", tri0)
        s.register("4-clique-tri")
        s.store.ensure("tri", (0,), 2)  # derived: ignores column 1
    assert ts.store.projections[("tri", (0,), 2)].derived
    live = e
    for epoch in range(3):
        if epoch == 2:
            faults.install({"store.commit.fold": {10**6}})
            jfaults.install({"store.commit.fold": {10**6}})
        upd, w = _dirty_batch(rng, nv, live, 12, 2)
        jr1, tr1 = js.update(upd, w), ts.update(upd, w)
        feed = {"tri": _feed(tr1.deltas["triangle"], 3)}
        jr2, tr2 = js.update(feed), ts.update(feed)
        _deltas_equal(tr2.deltas["4-clique-tri"], jr2.deltas["4-clique-tri"])
        live = tr1.advance(live)
    assert faults.counts() == jfaults.counts()
    assert faults.counts()["store.commit.fold"] > 0
    assert ts.stats.live_compactions > 0
    tl, tm = ts.snapshot()
    snaps_equal(js.snapshot(), (tl, tm))
    assert any(name.endswith(".lo") for name in tm["names"])
    assert any(p["derived"] for p in tm["projections"])


def _mid_epoch(s, leaves, meta):
    s.store.begin_epoch(np.array([[1, 2]], np.int32),
                        np.zeros((0, 2), np.int32))
    s.snapshot()


def _restore_with(change):
    def run(s, leaves, meta):
        leaves, meta = list(leaves), copy.deepcopy(meta)
        change(leaves, meta)
        s.restore(leaves, meta)
    return run


ERRORS = {
    "mid-epoch": (_mid_epoch, SnapshotError, "mid-epoch"),
    "format": (_restore_with(lambda l, m: m.update(format=2)), ValueError,
               "unknown snapshot format"),
    "shard_w": (_restore_with(lambda l, m: m.update(shard_w=4)), ValueError,
                "shard_w=4"),
    "w": (_restore_with(lambda l, m: m["session"].update(w=4)), ValueError,
          "4-worker"),
    "local": (_restore_with(lambda l, m: m["session"].update(local=False)),
              ValueError, "local/mesh"),
    "leaf missing": (_restore_with(lambda l, m: l.pop()), ValueError,
                     "do not match"),
    "name twice": (_restore_with(lambda l, m: m["names"].__setitem__(
        1, m["names"][0])), ValueError, "do not match"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_snapshot_error_paths(case):
    edges = tsyn.rmat_graph(5, 4, seed=1)
    s = GraphSession(edges, device="cpu", batch=64, out_capacity=1 << 12)
    s.register("triangle")
    leaves, meta = s.snapshot()
    fn, exc, msg = ERRORS[case]
    with pytest.raises(exc, match=msg):
        fn(s, leaves, meta)
    if case != "mid-epoch":  # a refused restore leaves the store as it was
        snaps_equal((leaves, meta), s.snapshot())
