"""Fault injection in the port (plain versions on the CPU) against the JAX
package: the registry's specs, hits and seeded schedules; a fault between
commit folds or at normalize leaves the store bit-identical to its
pre-epoch snapshot and the retried batch gives the never-failed twin's
delta; and one schedule faults at the same hit in both packages."""
import functools

import numpy as np
import pytest

from repro import faults as jfaults
from repro.api import GraphSession as JSession
from repro.core import delta as jdelta
from repro.errors import FaultInjected as JFaultInjected
from repro_torch import faults
from repro_torch.api import GraphSession, canon_signed
from repro_torch.core import query as Q
from repro_torch.core.bigjoin import BigJoinConfig
from repro_torch.core.delta import DeltaBigJoin, delta_oracle
from repro_torch.data.synthetic import uniform_graph
from repro_torch.errors import FaultInjected, ReproError

from tests.test_delta_stream import _start_edges, apply_net
from tests.test_faults import _snap_equal, _zipf_batch


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


SPECS = ["wal.fsync@7,store.commit.fold@3-5,pool.apply@*",
         "store.normalize", " dist.program@2 , ,snapshot.write@1-1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_reference(spec):
    assert faults.parse_spec(spec) == jfaults.parse_spec(spec)
    assert faults.POINTS == jfaults.POINTS
    assert (faults.ENV_VAR, faults.EVERY) == (jfaults.ENV_VAR, jfaults.EVERY)


@pytest.mark.parametrize("seed,rate", [(0, 0.05), (11, 0.1), (12, 0.3)])
def test_random_schedule_matches_reference(seed, rate):
    assert faults.random_schedule(seed, rate=rate) == \
        jfaults.random_schedule(seed, rate=rate)
    pts = ("store.commit.fold", "store.normalize")
    assert faults.random_schedule(seed, pts, horizon=50, rate=rate) == \
        jfaults.random_schedule(seed, pts, horizon=50, rate=rate)


def test_install_fire_counts_match_reference():
    """The same script of installs, fires and pauses against both
    registries: the same raises, counts and injected lists."""
    def script(reg, exc):
        log = []
        reg.install({"pool.prep": {2}, "store.normalize": {reg.EVERY}})
        log.append(reg.active())
        for point in ("pool.prep",) * 3 + ("store.normalize", "wal.append"):
            try:
                reg.fire(point)
                log.append((point, None))
            except exc as e:
                log.append((point, e.point, e.hit))
        with reg.disabled():
            reg.fire("store.normalize")
        log += [reg.counts(), reg.injected()]
        reg.install("pool.prep@1", reset_counts=False)
        log.append(reg.counts())
        reg.clear()
        log += [reg.active(), reg.counts()]
        return log

    got = script(faults, FaultInjected)
    assert got == script(jfaults, JFaultInjected)
    assert got[4] == ("store.normalize", "store.normalize", 1)
    assert issubclass(FaultInjected, ReproError)


def test_commit_fault_rolls_back_bit_identical():
    """The port's twin of the JAX suite's test of the same name."""
    q = Q.triangle()
    nv = 30
    edges = _start_edges(nv, 120, 1)
    engine = DeltaBigJoin(q, edges, cfg=BigJoinConfig(
        batch=64, seed_chunk=64, out_capacity=1 << 12), device="cpu")
    rng = np.random.default_rng(2)
    upd1, w1 = _zipf_batch(rng, nv, engine.store.edges.copy(), 16)
    engine.apply(upd1, w1)
    pre = engine.store.snapshot()
    pre_edges = engine.store.edges.copy()

    upd2, w2 = _zipf_batch(rng, nv, engine.store.edges.copy(), 16)
    faults.install({"store.commit.fold": {2}})
    with pytest.raises(FaultInjected):
        engine.apply(upd2, w2)
    engine.store.rollback()
    faults.clear()

    post = engine.store.snapshot()
    assert _snap_equal(pre, post), \
        "mid-commit fault left partial state after rollback"
    np.testing.assert_array_equal(engine.store.edges, pre_edges)
    assert engine.store.stats.rollbacks >= 1

    cur = engine.store.edges.copy()
    res = engine.apply(upd2, w2)
    after = apply_net(cur, upd2, w2)
    ot, ow = delta_oracle(q, cur, after)
    assert canon_signed(res.tuples, res.weights) == canon_signed(ot, ow)


@pytest.mark.parametrize("spec", ["store.normalize@1", "store.commit.fold@1",
                                  "store.commit.fold@3"])
def test_session_update_rolls_back_on_fault(spec):
    """The port's twin of the JAX suite's test of the same name, at
    normalize and at a live-set and a projection fold: a failed epoch
    leaves the epoch counter and the store's snapshot untouched; the
    retry matches the never-failed twin session."""
    g = uniform_graph(24, 100, 3)
    s = GraphSession(g, device="cpu")
    s.register("triangle")
    twin = GraphSession(g, device="cpu")
    twin.register("triangle")

    rng = np.random.default_rng(4)
    batches = [_zipf_batch(rng, 24, np.asarray(s.edges), 12)
               for _ in range(4)]
    s.update(*batches[0])
    twin.update(*batches[0])

    pre = s.snapshot()
    faults.install(spec)  # fails s's NEXT update only
    epoch_before = s.epoch
    with pytest.raises(FaultInjected):
        s.update(*batches[1])
    faults.clear()
    assert s.epoch == epoch_before
    assert _snap_equal(pre, s.snapshot())
    for upd, w in batches[1:]:
        rs = s.update(upd, w)
        rt = twin.update(upd, w)
        dq, dt = rs.deltas["triangle"], rt.deltas["triangle"]
        np.testing.assert_array_equal(dq.tuples, dt.tuples)
        np.testing.assert_array_equal(dq.weights, dt.weights)
    np.testing.assert_array_equal(np.asarray(s.edges),
                                  np.asarray(twin.edges))
    assert s.epoch == twin.epoch


@pytest.fixture(scope="module")
def _jax_plain():
    """The JAX session on its plain jnp paths (its own suites hold them
    bit-exact to its Pallas kernels): one compile per dataflow, fast."""
    import repro.api.session as jsession
    from repro.core.bigjoin import BigJoinConfig as JConfig
    mp = pytest.MonkeyPatch()
    mp.setattr(jsession, "BigJoinConfig",
               functools.partial(JConfig, use_kernel=False))
    mp.setattr(jdelta, "USE_MERGE_KERNEL", False)
    yield
    mp.undo()


@pytest.mark.parametrize("spec", ["store.commit.fold@1",
                                  "store.commit.fold@2",
                                  "store.commit.fold@3",
                                  "store.commit.fold@5",
                                  "store.normalize@1,store.commit.fold@6"])
def test_same_schedule_faults_at_the_same_hit(spec, _jax_plain):
    """One schedule installed in both packages over one stream: each
    epoch faults in both or in neither, the hit counters agree after
    every epoch, and after the retry the deltas and snapshots agree."""
    edges = _start_edges(20, 90, 5)
    kw = dict(batch=128, out_capacity=1 << 13, compact_ratio=0.3)
    js = JSession(edges, local=True, **kw)
    ts = GraphSession(edges, device="cpu", **kw)
    for s in (js, ts):  # a fold of the live set and of two projections
        s.register("triangle")
    jfaults.install(spec)
    faults.install(spec)
    rng = np.random.default_rng(6)
    live = edges
    for epoch in range(4):
        upd, w = _zipf_batch(rng, 20, live, 10)
        # each attempt in both packages, retried with the schedule armed
        # until it goes through
        for attempt in range(4):
            out = []
            for s, exc in ((js, JFaultInjected), (ts, FaultInjected)):
                try:
                    out.append(s.update(upd, w))
                except exc as e:
                    out.append((e.point, e.hit))
            assert faults.counts() == jfaults.counts(), (epoch, attempt)
            if isinstance(out[0], tuple) or isinstance(out[1], tuple):
                assert out[0] == out[1], (epoch, attempt, out)
                continue
            a, b = out[1].deltas["triangle"], out[0].deltas["triangle"]
            np.testing.assert_array_equal(a.tuples, b.tuples)
            np.testing.assert_array_equal(a.weights, b.weights)
            break
        live = apply_net(live, upd, w)
    assert len(faults.injected()) == len(spec.split(","))
    assert faults.injected() == jfaults.injected()
    assert ts.epoch == js.epoch == 4
    assert _snap_equal(js.snapshot(), ts.snapshot())
