"""The streaming mesh of the port (``DistDeltaBigJoin``, the mesh
``GraphSession``, ``run_program``) against the JAX package's, on the CPU.

The JAX side runs in subprocesses with four host devices (its own
pattern): each makes its cases' graphs from a numpy seed, draws every
epoch's dirty update batch from the JAX package's ``EdgeUpdateStream``,
runs them and writes one ``.npz`` of the batches and results.  The port
replays the same batches on w workers as a leading tensor axis, and each
epoch must agree bit for bit: the signed tuples and weights in order,
``count_delta``, every delta plan's count, proposals, intersections and
steps; then the final snapshot leaf for leaf, and the escalation
counters.  The JAX engines run their plain jnp paths (``use_kernel``
off, ``REPRO_MERGE_KERNEL=0``), which its own suites hold bit-exact to its
Pallas kernels, so each program compiles once.

Beside them, in processes of their own, the port's mesh harnesses and
drivers run on ``--device cpu`` at a small size.
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

MUT = "mut(a,b,c) := e(a,b), e(b,a), e(b,c)"
ENGINE = dict(kind="engine", batch=256, out=1 << 14, balance=False,
              ratio=0.5, bs=40, route=0, star=0)
# Two groups, one JAX process each, run side by side.  ``mut`` is the
# route case: a plan with a seed filter (the mutual edge) and a star batch
# that sends more than half of a worker's seeds to one owner; the
# standard queries have no seed filter, and only a seed filter's reply can
# overflow a route (elsewhere an unanswered request defers).
GROUPS = [
    {
        "tri-w4": dict(ENGINE, query="triangle", w=4, nv=40, ne=300, seed=0,
                       ratio=0.3, epochs=6),
        "tri-w4-balance": dict(ENGINE, query="triangle", w=4, nv=40, ne=300,
                               seed=1, balance=True, epochs=4),
        # the session's config is tri-w4's, so JAX reuses its programs
        "session-edge": dict(kind="session", w=4, nv=40, ne=300, seed=6,
                             queries=["triangle"], batch=256,
                             out=1 << 14, bs=32, epochs=5, static=True,
                             snap_at=3),
        "mut-route": dict(ENGINE, query=MUT, w=4, nv=400, ne=600, seed=4,
                          epochs=1, route=16, star=300),
    },
    {
        "session-nary": dict(kind="session", w=4, nv=24, ne=160, seed=5,
                             queries=["triangle", "4-clique-tri"],
                             batch=256, out=1 << 14, bs=16, epochs=3,
                             static=False, snap_at=-1),
        # two workers and a route of 32 slots: requests past it defer
        "diamond-w2-defer": dict(ENGINE, query="diamond", w=2, nv=30,
                                 ne=150, seed=2, bs=24, epochs=4, route=32),
    },
]
CASES = {k: v for g in GROUPS for k, v in g.items()}

_JAX_RUNNER = r"""
import dataclasses, json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.api import GraphSession
from repro.api.dsl import parse_pattern
from repro.core import query as Q
from repro.core.distributed import AXIS, DistDeltaBigJoin, default_delta_config
from repro.data.synthetic import EdgeUpdateStream, uniform_graph

cases, out_path = json.loads(sys.argv[1]), sys.argv[2]
res = {}

def put_snap(prefix, snap):
    leaves, meta = snap
    for i, a in enumerate(leaves):
        res[f"{prefix}/leaf/{i}"] = np.asarray(a)
    res[f"{prefix}/meta"] = np.array(json.dumps(meta))

def put_delta(prefix, d, m):
    t = d.tuples if d.tuples is not None else np.zeros((0, m), np.int32)
    w = d.weights if d.weights is not None else np.zeros(0, np.int32)
    res[f"{prefix}/tuples"] = np.asarray(t, np.int32)
    res[f"{prefix}/weights"] = np.asarray(w, np.int32)
    res[f"{prefix}/stats"] = np.array(
        [d.count_delta] + [x for r in d.per_dq for x in
                           (r.count, r.proposals, r.intersections, r.steps)],
        np.int64)

for name, c in cases.items():
    mesh = Mesh(np.array(jax.devices()[:c["w"]]), (AXIS,))
    e = uniform_graph(c["nv"], c["ne"], c["seed"])
    res[f"{name}/edges"] = e
    stream = EdgeUpdateStream(c["nv"], c["bs"], seed=c["seed"] + 1)
    if c["kind"] == "engine":
        q = parse_pattern(c["query"]) if ":=" in c["query"] \
            else Q.query_by_name(c["query"])
        dcfg = default_delta_config(c["w"], batch=c["batch"],
                                    out_capacity=c["out"],
                                    balance=c["balance"], use_kernel=False)
        if c["route"]:
            dcfg = dataclasses.replace(dcfg, route_capacity=c["route"])
        eng = DistDeltaBigJoin(q, e, mesh=mesh, dcfg=dcfg,
                               compact_ratio=c["ratio"])
        cur = e
        for step in range(c["epochs"]):
            if c["star"] and step == 0:
                v = np.arange(1, c["star"], dtype=np.int32)
                upd = np.stack([v, np.zeros_like(v)], 1)
                w = np.ones(len(upd), np.int32)
            else:
                upd, w = stream.batch_at(step, live=cur)
            res[f"{name}/{step}/upd"], res[f"{name}/{step}/w"] = upd, w
            put_delta(f"{name}/{step}", eng.apply(upd, w), q.num_attrs)
            cur = eng.edges.copy()
        put_snap(f"{name}/final", eng.store.snapshot())
        st = eng.store.stats
        res[f"{name}/stats"] = np.array(
            [st.escalations, st.replays, st.compactions,
             st.live_compactions])
        continue
    s = GraphSession(e, local=False, mesh=mesh, batch=c["batch"],
                     out_capacity=c["out"], update_batch=c["bs"])
    handles = {}
    for qn in c["queries"]:
        if qn == "4-clique-tri":
            tri0, _ = handles["triangle"].enumerate()
            res[f"{name}/tri0"] = np.asarray(tri0, np.int32)
            s.add_relation("tri", tri0)
        handles[qn] = s.register(qn)
    live = s.edges
    try:
        for step in range(c["epochs"]):
            if step == c["snap_at"]:
                put_snap(f"{name}/snap", s.snapshot())
            upd, w = stream.batch_at(step, live=live)
            res[f"{name}/{step}/upd"], res[f"{name}/{step}/w"] = upd, w
            r1 = s.update(upd, w)
            live = r1.advance(live)
            put_delta(f"{name}/{step}/triangle", r1.deltas["triangle"], 3)
            if "4-clique-tri" in c["queries"]:
                td = r1.deltas["triangle"]
                t = td.tuples if td.tuples is not None else \
                    np.zeros((0, 3), np.int32)
                tw = td.weights if td.weights is not None else \
                    np.zeros(0, np.int32)
                r2 = s.update({"tri": (t, tw)})
                put_delta(f"{name}/{step}/4-clique-tri",
                          r2.deltas["4-clique-tri"], 4)
        for qn in c["queries"] if c["static"] else ():
            res[f"{name}/count/{qn}"] = np.array(handles[qn].count())
            t, w = handles[qn].enumerate()
            res[f"{name}/enum/{qn}/tuples"] = np.asarray(t, np.int32)
            res[f"{name}/enum/{qn}/weights"] = np.asarray(w, np.int32)
        put_snap(f"{name}/final", s.snapshot())
    except Exception as exc:  # a JAX-side quirk is a finding, not a stop
        res[f"{name}/raised"] = np.array(f"{type(exc).__name__}: {exc}")
np.savez(out_path, **res)
"""

# the port's harnesses and drivers, each a process on the CPU
HARNESSES = {
    "delta-dist": ["-m", "repro_torch.core._delta_dist_check", "--device",
                   "cpu", "--workers", "4", "--batches", "4"],
    "nary-dist": ["-m", "repro_torch.core._nary_dist_check", "--device",
                  "cpu", "--workers", "4", "--batches", "3"],
    "run-query": ["-m", "repro_torch.launch.run_query", "--mode",
                  "distributed", "--workers", "4", "--device", "cpu",
                  "--scale", "7", "--verify"],
    "serve-check": ["-m", "repro_torch.serve._serve_check", "--device",
                    "cpu", "--tenants", "2", "--workers", "4", "--epochs",
                    "4"],
    "serve-chaos": ["-m", "repro_torch.serve._serve_check", "--device",
                    "cpu", "--tenants", "2", "--workers", "4", "--epochs",
                    "5", "--chaos", "--faults",
                    "dist.program@2,store.commit.fold@4,pool.apply@7"],
    "serve-stream": ["-m", "repro_torch.launch.serve", "--stream",
                     "--workers", "4", "--balance", "--device", "cpu",
                     "--scale", "6", "--epochs", "2", "--batch-size", "32",
                     "--verify"],
    "serve-concurrent": ["-m", "repro_torch.launch.serve", "--concurrent",
                         "2", "--workers", "2", "--device", "cpu",
                         "--scale", "6", "--epochs", "2", "--batch-size",
                         "32", "--verify"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions at these sizes run faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_faults():
    from repro_torch import faults
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every JAX group and every harness started together; the JAX
    results merged into one dict, the harnesses' (rc, stdout, stderr)."""
    tmp = tmp_path_factory.mktemp("mesh_stream")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", REPRO_MERGE_KERNEL="0",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=4")
    procs = {}
    for i, group in enumerate(GROUPS):
        procs[f"jax{i}"] = subprocess.Popen(
            [sys.executable, "-c", _JAX_RUNNER, json.dumps(group),
             str(tmp / f"jax{i}.npz")], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, argv in HARNESSES.items():
        procs[name] = subprocess.Popen(
            [sys.executable] + argv, env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        so, se = p.communicate(timeout=600)
        out[name] = (p.returncode, so, se)
    jax = {}
    for i in range(len(GROUPS)):
        rc, _, se = out[f"jax{i}"]
        assert rc == 0, se[-4000:]
        jax.update(dict(np.load(tmp / f"jax{i}.npz")))
    return jax, out


def snap_equal(jax: dict, prefix: str, snap) -> None:
    leaves, meta = snap
    want = json.loads(str(jax[f"{prefix}/meta"]))
    assert json.loads(json.dumps(meta)) == want
    for i, (name, a) in enumerate(zip(meta["names"], leaves)):
        b = jax[f"{prefix}/leaf/{i}"]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        np.testing.assert_array_equal(a, b, err_msg=name)


def delta_equal(jax: dict, prefix: str, d) -> None:
    want_t = jax[f"{prefix}/tuples"]
    t = d.tuples if d.tuples is not None else \
        np.zeros((0, want_t.shape[1]), np.int32)
    w = d.weights if d.weights is not None else np.zeros(0, np.int32)
    np.testing.assert_array_equal(t, want_t, err_msg=prefix)
    np.testing.assert_array_equal(w, jax[f"{prefix}/weights"],
                                  err_msg=prefix)
    np.testing.assert_array_equal(
        np.array([d.count_delta] + [x for r in d.per_dq for x in
                                    (r.count, r.proposals, r.intersections,
                                     r.steps)]),
        jax[f"{prefix}/stats"], err_msg=prefix)


def _mesh(w):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(w, "cpu")


def _engine(name, jax):
    import dataclasses
    from repro_torch.api.dsl import parse_pattern
    from repro_torch.core import query as Q
    from repro_torch.core.distributed import (DistDeltaBigJoin,
                                              default_delta_config)
    c = CASES[name]
    q = parse_pattern(c["query"]) if ":=" in c["query"] \
        else Q.query_by_name(c["query"])
    dcfg = default_delta_config(c["w"], batch=c["batch"],
                                out_capacity=c["out"], balance=c["balance"])
    if c["route"]:
        dcfg = dataclasses.replace(dcfg, route_capacity=c["route"])
    return DistDeltaBigJoin(q, jax[f"{name}/edges"], mesh=_mesh(c["w"]),
                            dcfg=dcfg, compact_ratio=c["ratio"])


@pytest.mark.parametrize("name", [k for k, c in CASES.items()
                                  if c["kind"] == "engine"])
def test_engine_matches_jax(name, runs):
    jax, _ = runs
    eng = _engine(name, jax)
    for step in range(CASES[name]["epochs"]):
        res = eng.apply(jax[f"{name}/{step}/upd"], jax[f"{name}/{step}/w"])
        delta_equal(jax, f"{name}/{step}", res)
    snap_equal(jax, f"{name}/final", eng.store.snapshot())
    st = eng.store.stats
    assert [st.escalations, st.replays, st.compactions,
            st.live_compactions] == jax[f"{name}/stats"].tolist()
    if name == "mut-route":  # the route rung grew, then the replay ran
        assert st.escalations > 0
        assert eng.store.ratchet.peek(("cap", "route", "mut")) > 16
    if name == "diamond-w2-defer":  # deferral, never an overflow
        assert st.escalations == 0


def _session(name, jax, **kw):
    from repro_torch.api import GraphSession
    c = CASES[name]
    return GraphSession(jax[f"{name}/edges"], device="cpu",
                        mesh=_mesh(c["w"]), batch=c["batch"],
                        out_capacity=c["out"], update_batch=c["bs"], **kw)


def test_mesh_session_nary_matches_jax(runs):
    """triangle feeding ``tri`` and 4-clique-tri over it, on the mesh:
    composite keys on up to three columns in the sharded regions."""
    jax, _ = runs
    name = "session-nary"
    assert f"{name}/raised" not in jax
    s = _session(name, jax)
    tri = s.register("triangle")
    tri0, _ = tri.enumerate()
    np.testing.assert_array_equal(tri0, jax[f"{name}/tri0"])
    s.add_relation("tri", tri0)
    s.register("4-clique-tri")
    for step in range(CASES[name]["epochs"]):
        r1 = s.update(jax[f"{name}/{step}/upd"], jax[f"{name}/{step}/w"])
        delta_equal(jax, f"{name}/{step}/triangle", r1.deltas["triangle"])
        td = r1.deltas["triangle"]
        r2 = s.update({"tri": (td.tuples, td.weights)})
        delta_equal(jax, f"{name}/{step}/4-clique-tri",
                    r2.deltas["4-clique-tri"])
    snap_equal(jax, f"{name}/final", s.snapshot())


def test_mesh_session_matches_jax(runs):
    """The edge session: each epoch, the snapshot at epoch 3 and at the
    end, and ``count()``/``enumerate()`` through ``run_program``."""
    from repro_torch.core import distributed as D
    jax, _ = runs
    name = "session-edge"
    s = _session(name, jax)
    h = s.register("triangle")
    assert (s.local, s.w, s.store.shard_w) == (False, 4, 4)
    for step in range(CASES[name]["epochs"]):
        if step == CASES[name]["snap_at"]:
            snap_equal(jax, f"{name}/snap", s.snapshot())
        r = s.update(jax[f"{name}/{step}/upd"], jax[f"{name}/{step}/w"])
        delta_equal(jax, f"{name}/{step}/triangle", r.deltas["triangle"])
    calls = []
    real = D.run_program
    try:
        D.run_program = lambda *a, **k: calls.append(1) or real(*a, **k)
        assert h.count() == int(jax[f"{name}/count/triangle"])
        t, w = h.enumerate()
    finally:
        D.run_program = real
    assert len(calls) == 2
    np.testing.assert_array_equal(t, jax[f"{name}/enum/triangle/tuples"])
    np.testing.assert_array_equal(w, jax[f"{name}/enum/triangle/weights"])
    snap_equal(jax, f"{name}/final", s.snapshot())


def _jax_snap(jax, prefix):
    meta = json.loads(str(jax[f"{prefix}/meta"]))
    return [jax[f"{prefix}/leaf/{i}"] for i in
            range(len(meta["names"]))], meta


def test_jax_mesh_snapshot_restores_into_port(runs):
    """The JAX mesh session's snapshot at epoch 3 restored into a port
    mesh session built over one edge; the two epochs after it equal."""
    from repro_torch.api import GraphSession
    jax, _ = runs
    name = "session-edge"
    c = CASES[name]
    s = GraphSession(np.array([[0, 1]], np.int32), device="cpu",
                     mesh=_mesh(c["w"]), batch=c["batch"],
                     out_capacity=c["out"], update_batch=c["bs"])
    s.restore(*_jax_snap(jax, f"{name}/snap"))
    assert s.epoch == 3 and "triangle" in s.handles
    for step in range(3, c["epochs"]):
        r = s.update(jax[f"{name}/{step}/upd"], jax[f"{name}/{step}/w"])
        delta_equal(jax, f"{name}/{step}/triangle", r.deltas["triangle"])
    snap_equal(jax, f"{name}/final", s.snapshot())
    # a snapshot of another mesh width or mode is refused
    leaves, meta = _jax_snap(jax, f"{name}/snap")
    for other in (GraphSession(np.array([[0, 1]], np.int32), device="cpu",
                               mesh=_mesh(2)),
                  GraphSession(np.array([[0, 1]], np.int32), device="cpu")):
        with pytest.raises(ValueError, match="4-worker"):
            other.restore(leaves, meta)
    local = GraphSession(np.array([[0, 1]], np.int32), device="cpu")
    meta = dict(meta, session=dict(meta["session"], w=1))
    with pytest.raises(ValueError, match="local/mesh"):
        local.restore(leaves, meta)


def test_dist_program_fault_rolls_back(runs):
    """A ``dist.program@1`` fault inside an epoch rolls the session back
    to the epoch boundary (the live set, the epoch, nothing staged; a
    compaction that ``begin_epoch`` ran before the fault is layout only
    and stays); the retry gives the fault-free delta, and the session
    then equals the fault-free JAX session's snapshot leaf for leaf (its
    counters but one normalize more)."""
    from repro_torch import faults
    from repro_torch.errors import FaultInjected
    jax, _ = runs
    name = "session-edge"
    s = _session(name, jax)
    s.register("triangle")
    for step in range(2):
        s.update(jax[f"{name}/{step}/upd"], jax[f"{name}/{step}/w"])
    live = s.edges.copy()
    faults.install("dist.program@1")
    with pytest.raises(FaultInjected):
        s.update(jax[f"{name}/2/upd"], jax[f"{name}/2/w"])
    assert faults.injected() == [("dist.program", 1)]
    faults.clear()
    assert s.epoch == 2 and s.stats.rollbacks == 1
    assert s.store._staged is None
    np.testing.assert_array_equal(s.edges, live)
    r = s.update(jax[f"{name}/2/upd"], jax[f"{name}/2/w"])
    delta_equal(jax, f"{name}/2/triangle", r.deltas["triangle"])
    leaves, meta = s.snapshot()
    meta = json.loads(json.dumps(meta))
    assert meta["stats"]["normalize_calls"] == 4  # 3 epochs and the fault
    meta["stats"]["normalize_calls"] = 3
    r = s.update(jax[f"{name}/3/upd"], jax[f"{name}/3/w"])
    delta_equal(jax, f"{name}/3/triangle", r.deltas["triangle"])
    snap_equal(jax, f"{name}/snap", (leaves, meta))


def test_one_program_run_per_plan_and_epoch(runs):
    """A warm epoch runs each delta plan's program once, from the
    process-wide cache: no program is built after the first epoch."""
    from repro_torch.core import distributed as D
    jax, _ = runs
    name = "session-edge"
    s = _session(name, jax)
    s.register("triangle")
    s.prewarm()
    assert s.store.ratchet.peek(("seed", 2)) > 0  # pinned, as JAX pins it
    calls = []
    real = D.run_program
    D.run_program = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        s.update(jax[f"{name}/0/upd"], jax[f"{name}/0/w"])
        built = D._PROGRAM_BUILDS
        for step in (1, 2):
            calls.clear()
            s.update(jax[f"{name}/{step}/upd"], jax[f"{name}/{step}/w"])
            assert len(calls) == 3  # triangle's three delta plans
        assert D._PROGRAM_BUILDS == built
    finally:
        D.run_program = real


def test_mesh_entry_points_need_the_card():
    """``device=None`` means the card: without CUDA the mesh's entry
    points raise; with a mismatched device they refuse."""
    from repro_torch.api import GraphSession
    from repro_torch.core import query as Q
    from repro_torch.core.distributed import (DistDeltaBigJoin,
                                              make_delta_monitor)
    from repro_torch.serve import SessionPool
    e = np.array([[0, 1], [1, 2], [0, 2]], np.int32)
    with pytest.warns(DeprecationWarning):
        m = make_delta_monitor(Q.triangle(), e, mesh=_mesh(2), device="cpu")
    assert m.w == 2 and m.store.shard_w == 2
    with pytest.raises(ValueError, match="device"):
        DistDeltaBigJoin(Q.triangle(), e, mesh=_mesh(2), device="meta")
    if torch.cuda.is_available():
        return
    for make in (lambda: GraphSession(e, local=False),
                 lambda: SessionPool(local=False),
                 lambda: SessionPool(balance=True, local=False),
                 lambda: DistDeltaBigJoin(Q.triangle(), e),
                 lambda: make_delta_monitor(Q.triangle(), e)):
        with pytest.raises(RuntimeError, match="CUDA"), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            make()


@pytest.mark.parametrize("name", sorted(HARNESSES))
def test_mesh_harness_on_cpu(name, runs):
    _, out = runs
    rc, so, se = out[name]
    assert rc == 0, (so[-2000:], se[-3000:])
    if name == "run-query":
        assert "w=4 mesh" in so and "✓" in so
        return
    if name == "serve-stream":
        assert "4-worker mesh on cpu (balanced)" in so and "✓" in so
        return
    if name == "serve-concurrent":
        assert "2-worker mesh on cpu" in so and so.count("✓") == 2
        return
    rec = json.loads(so.strip().splitlines()[-1])
    assert rec["workers"] == 4 and rec["device"] == "cpu"
    if name == "serve-check":
        assert rec["oracle_exact"] and not rec["local"]
        assert rec["serve_compiles"] == 0
    elif name == "serve-chaos":
        assert rec["oracle_exact"] and rec["accounted"]
        assert ["dist.program", 2] in rec["injected"] or \
            "dist.program@2" in rec["injected"]
    else:
        assert rec["all_exact"]
