"""The port's serving layer (``repro_torch.serve``) on the CPU against the
JAX package's (``repro.serve``), exactly: the WAL's record bytes, each
package recovering the other's durable directory, the pipelined
multi-tenant pool, coalescing, backpressure, bad batches and quarantine,
WAL retry and degrade and a failed snapshot under the same fault schedule
in both packages, the admission prewarm's ratchet marks, and the
``_serve_check`` harness's three modes in processes of their own.

The JAX sessions run their plain jnp paths (``use_kernel=False``, no
merge kernel), which its own suites hold bit for bit to its Pallas
kernels: one compile per dataflow keeps the file fast."""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro import serve as jserve
from repro.serve import wal as jwal
from repro.api import GraphSession as JSession
from repro.core import delta as jdelta
from repro_torch import faults, serve
from repro_torch.serve import wal as twal
from repro_torch.api import GraphSession, canon_signed as canon
from repro_torch.core import compilestats
from repro_torch.data.synthetic import (EdgeUpdateStream,
                                        clean_update_batches, uniform_graph)
from repro_torch.kernels import _build

from tests.test_torch_nary import _deltas_equal

ROOT = Path(__file__).resolve().parents[1]
QUERY = "triangle"


@pytest.fixture(autouse=True)
def _jax_plain(monkeypatch):
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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions at these sizes run faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pools(**kw):
    """The port's pool and the JAX one with the same settings."""
    return (serve.SessionPool(device="cpu", **kw),
            jserve.SessionPool(local=True, **kw))


def _stream(i=0, nv=24, batch=16):
    return EdgeUpdateStream(nv, batch, insert_frac=0.5, seed=20 + i)


def _batches(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 50, (8, 2)).astype(np.int32),
             rng.choice([-1, 1], 8).astype(np.int32)) for _ in range(n)]


# -- WAL ------------------------------------------------------------------


def test_wal_writes_the_jax_bytes_and_each_replays_the_other(tmp_path):
    """Same epochs and batches (an edge and a ternary relation, empty
    batches among them): byte-identical files, and each package's
    ``replay`` reads the other's file to the same batches."""
    paths = {k: str(tmp_path / f"{k}.log") for k in ("t", "j")}
    wals = {"t": serve.WriteAheadLog(paths["t"], fsync=False),
            "j": jserve.WriteAheadLog(paths["j"], fsync=False)}
    rng = np.random.default_rng(1)
    recs = []
    for epoch, (rows, w) in enumerate(_batches(5), start=1):
        batches = {"edge": (rows, w)}
        if epoch % 2:
            tri = rng.integers(0, 9, (epoch, 3)).astype(np.int32)
            batches["tri"] = (tri, np.ones(epoch, np.int32))
        if epoch == 3:
            batches["edge"] = (rows[:0], w[:0])
        recs.append((epoch, batches))
        for wal in wals.values():
            wal.append(epoch, batches)
    for wal in wals.values():
        wal.close()
    assert Path(paths["t"]).read_bytes() == Path(paths["j"]).read_bytes()
    for reader, path in ((serve.WriteAheadLog, paths["j"]),
                         (jserve.WriteAheadLog, paths["t"])):
        got = list(reader(path, fsync=False).replay())
        assert [e for e, _ in got] == [e for e, _ in recs]
        for (_, a), (_, b) in zip(got, recs):
            assert sorted(a) == sorted(b)
            for rel in b:
                for x, y in zip(a[rel], b[rel]):
                    assert x.dtype == np.int32
                    np.testing.assert_array_equal(x, y)


def test_wal_roundtrip_truncate_torn(tmp_path):
    """The reference's WAL test on the port: replay, truncation keeping
    the tail byte for byte, a torn tail ending replay."""
    path = str(tmp_path / "wal.log")
    wal = serve.WriteAheadLog(path, fsync=False)
    recs = dict(enumerate(_batches(5), start=1))
    for epoch, b in recs.items():
        wal.append(epoch, {"edge": b})
    replayed = list(wal.replay())
    assert [e for e, _ in replayed] == [1, 2, 3, 4, 5]
    for epoch, batches in replayed:
        np.testing.assert_array_equal(batches["edge"][0], recs[epoch][0])
        np.testing.assert_array_equal(batches["edge"][1], recs[epoch][1])
    tail = Path(path).read_bytes().splitlines(keepends=True)[3:]
    wal.truncate_through(3)
    assert [e for e, _ in wal.replay()] == [4, 5]
    assert Path(path).read_bytes() == b"".join(tail)
    assert wal.num_records() == 2
    wal.close()
    with open(path, "ab") as f:
        f.write(b'{"b": "{\\"e\\": 6')  # half-written record
    wal2 = serve.WriteAheadLog(path, fsync=False)
    assert [e for e, _ in wal2.replay()] == [4, 5]
    wal2.close()


@pytest.mark.parametrize("damage", ["clean", "torn_tail", "corrupt_midfile",
                                    "abort_last"])
def test_wal_verify_and_abort_last_as_the_reference(tmp_path, damage,
                                                    capsys):
    """The same damage to each package's file: ``verify`` reports the
    same status, counts and epochs, ``main`` the same exit code; and
    ``abort_last`` truncates back to the record's start in both."""
    out = {}
    for name, mod in (("t", twal), ("j", jwal)):
        d = tmp_path / name
        path = str(d / "wal.log")
        wal = mod.WriteAheadLog(path, fsync=False)
        for epoch, b in enumerate(_batches(4), start=1):
            wal.append(epoch, {"edge": b})
        if damage == "abort_last":
            assert wal.abort_last() and not wal.abort_last()
        wal.close()
        lines = Path(path).read_bytes().splitlines(keepends=True)
        if damage == "torn_tail":
            lines[-1] = lines[-1][:40]
        elif damage == "corrupt_midfile":
            lines[1] = lines[1].replace(b'"crc": ', b'"crc": 1')
        Path(path).write_bytes(b"".join(lines))
        rep = mod.WriteAheadLog.verify(path)
        rep.pop("path")
        rc = mod.main(["verify", str(d)])
        printed = json.loads(capsys.readouterr().out.strip())
        printed.pop("path")
        assert printed == rep
        out[name] = (rep, rc, Path(path).read_bytes())
    assert out["t"] == out["j"]
    rep, rc, _ = out["t"]
    assert rep["status"] == ("clean" if damage in ("clean", "abort_last")
                             else damage)
    assert rc == (2 if damage == "corrupt_midfile" else 0)
    assert rep["records"] == {"clean": 4, "torn_tail": 3,
                              "corrupt_midfile": 1, "abort_last": 3}[damage]


# -- Durability across the packages ---------------------------------------


def _drive_pool(pool, graph, stream, epochs, **admit):
    h = pool.admit("t0", graph, queries=(QUERY,), coalesce=1, **admit)
    live = np.asarray(h.session.edges)
    for step in range(epochs):
        upd, w = stream.batch_at(step, live=live)
        live = h.submit(upd, w).result(timeout=600).advance(live)
    pool.close()
    return h.session, live


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_durability_recovers_the_other_packages_directory(tmp_path, writer):
    """A pool of one package serves 7 epochs into a durable directory
    (snapshots at 3 and 6, epoch 7 left in the WAL); the other package's
    ``Durability`` recovers it into a fresh session, and the next 3
    epochs' deltas, the final state and the snapshots equal the writer's
    session going on."""
    g = uniform_graph(24, 160, seed=3)
    stream = _stream(3)
    kw = dict(update_batch=64, prewarm=False, durable_dir=str(tmp_path),
              snapshot_every=3, fsync=False)
    if writer == "jax":
        pool = jserve.SessionPool(local=True, **kw)
        fresh = GraphSession(g, device="cpu", update_batch=64)
        dur = serve.Durability(str(tmp_path / "t0"), fresh,
                               snapshot_every=3, fsync=False)
    else:
        pool = serve.SessionPool(device="cpu", **kw)
        fresh = JSession(g, local=True, update_batch=64)
        dur = jserve.Durability(str(tmp_path / "t0"), fresh,
                                snapshot_every=3, fsync=False)
    src, live = _drive_pool(pool, g, stream, 7)
    assert dur.recover()
    assert (fresh.epoch, dur.replayed) == (7, 1)
    assert dur.wal_report["status"] == "clean"
    np.testing.assert_array_equal(fresh.edges, src.edges)
    assert fresh[QUERY].net_change == src[QUERY].net_change
    for step in range(7, 10):
        upd, w = stream.batch_at(step, live=live)
        a, b = fresh.update(upd, w), src.update(upd, w)
        _deltas_equal(a.deltas[QUERY], b.deltas[QUERY])
        live = b.advance(live)
    from tests.test_torch_snapshot import snaps_equal
    snaps_equal(fresh.snapshot(), src.snapshot(), stats=False)
    dur.close()


# -- SessionPool ----------------------------------------------------------


def test_pool_multi_tenant_pipelined_matches_jax_and_isolated():
    """Two tenants through the port's pipelined pool: every epoch's delta
    equals the JAX pool's and an isolated port session's, bit for bit,
    and the final states agree."""
    graphs = {n: uniform_graph(24, 160, seed=i)
              for i, n in enumerate(["a", "b"])}
    streams = {n: _stream(i) for i, n in enumerate(graphs)}
    iso = {}
    for n, g in graphs.items():
        iso[n] = GraphSession(g, device="cpu", update_batch=64)
        iso[n].register(QUERY)
    tpool, jpool = _pools(update_batch=64, prewarm=False)
    with tpool, jpool:
        th = {n: tpool.admit(n, g, queries=(QUERY,), coalesce=1)
              for n, g in graphs.items()}
        jh = {n: jpool.admit(n, g, queries=(QUERY,), coalesce=1)
              for n, g in graphs.items()}
        lives = {n: np.asarray(h.session.edges) for n, h in th.items()}
        for step in range(6):
            tickets = {}
            for n in graphs:
                upd, w = streams[n].batch_at(step, live=lives[n])
                tickets[n] = (th[n].submit(upd, w), jh[n].submit(upd, w),
                              upd, w)
            for n, (tt, jt, upd, w) in tickets.items():
                res, jres = tt.result(timeout=600), jt.result(timeout=600)
                assert res.epoch == jres.epoch == step + 1
                _deltas_equal(res.deltas[QUERY], jres.deltas[QUERY])
                d, od = res.deltas[QUERY], iso[n].update(upd, w).deltas[QUERY]
                assert canon(d.tuples, d.weights) == \
                    canon(od.tuples, od.weights)
                lives[n] = res.advance(lives[n])
        for n in graphs:
            np.testing.assert_array_equal(th[n].session.edges, iso[n].edges)
            np.testing.assert_array_equal(th[n].session.edges,
                                          jh[n].session.edges)
        st = tpool.stats()
        assert st.tenants["a"].retired == st.tenants["b"].retired == 6
        assert st.prewarm_compiles == st.serve_compiles == 0


def test_pool_coalescing_matches_jax():
    """Six queued clean batches, one pump: the same coalesce groups as the
    JAX pool, each folded epoch's delta equal to its, the net state equal
    to one-by-one application."""
    g = uniform_graph(24, 160, seed=30)
    oracle = GraphSession(g, device="cpu", update_batch=256)
    oracle.register(QUERY)
    tpool, jpool = _pools(update_batch=256, prewarm=False, pipeline=False)
    th = tpool.admit("a", g, queries=(QUERY,), coalesce=4)
    jh = jpool.admit("a", g, queries=(QUERY,), coalesce=4)
    tickets = []
    for upd, w in clean_update_batches(g, 24, 16, 6, seed=31):
        oracle.update(upd, w)
        tickets.append((th.submit(upd, w), jh.submit(upd, w)))
    tpool.pump()
    jpool.pump()
    for tt, jt in tickets:
        res, jres = tt.result(timeout=1), jt.result(timeout=1)
        assert res.epoch == jres.epoch
        _deltas_equal(res.deltas[QUERY], jres.deltas[QUERY])
    np.testing.assert_array_equal(th.session.edges, oracle.edges)
    assert th.session[QUERY].net_change == oracle[QUERY].net_change
    st, jst = th.stats, jh.stats
    assert (st.retired, st.epochs, st.coalesced_away) == \
        (jst.retired, jst.epochs, jst.coalesced_away)
    assert st.epochs < 6 and st.coalesced_away == 6 - st.epochs
    tpool.close()
    jpool.close()


def test_pool_backpressure_sheds():
    g = uniform_graph(24, 160, seed=40)
    pool = serve.SessionPool(device="cpu", update_batch=64, prewarm=False,
                             pipeline=False)
    h = pool.admit("a", g, queries=(QUERY,), max_queue=2, coalesce=1)
    upd = np.array([[1, 2], [3, 4]], np.int32)
    w = np.ones(2, np.int32)
    t1, t2 = h.submit(upd, w), h.submit(upd, w)
    assert t1 is not None and t2 is not None
    assert h.submit(upd, w, block=False) is None
    assert h.submit(upd, w, timeout=0.05) is None  # timed block sheds too
    assert h.stats.shed == 2 and h.stats.queue_depth == 2
    pool.pump()
    assert t1.done() and t2.done()
    assert h.stats.retired == 2
    pool.close()


@pytest.mark.parametrize("bad_in_a_row", [1, 2])
def test_pool_bad_batch_and_quarantine_match_jax(bad_in_a_row):
    """A bad batch (arity mismatch) fails its ticket and the pool keeps
    serving; ``quarantine_after`` failures in a row fence the tenant off
    (queued tickets failed, new submits refused), as in the JAX pool."""
    g = uniform_graph(24, 160, seed=50)
    results = {}
    for name, pool in zip("tj", _pools(update_batch=64, prewarm=False,
                                       pipeline=False, quarantine_after=2)):
        h = pool.admit("a", g, queries=(QUERY,), coalesce=1)
        bad = [h.submit(np.zeros((2, 3), np.int32))
               for _ in range(bad_in_a_row)]
        ok = h.submit(np.array([[1, 2]], np.int32))
        pool.pump()
        for t in bad:
            with pytest.raises(Exception):
                t.result(timeout=10)
        if bad_in_a_row < 2:
            assert ok.result(timeout=10).epoch == 1
        else:
            with pytest.raises(RuntimeError, match="quarantined"):
                ok.result(timeout=10)
            with pytest.raises(RuntimeError, match="quarantined"):
                h.submit(np.array([[1, 2]], np.int32))
        st = h.stats
        results[name] = (st.failed, st.retired, st.quarantined,
                         st.epochs, h.session.epoch)
        pool.close()
    assert results["t"] == results["j"]
    assert results["t"][2] == (bad_in_a_row == 2)


def _faulted_run(pool, tmp_dir, schedule, fault_mod, epochs=5):
    """One tenant through ``pool`` under ``schedule``; returns the
    epochs' deltas and the tenant's stats."""
    g = uniform_graph(24, 160, seed=60)
    stream = _stream(6)
    h = pool.admit("a", g, queries=(QUERY,), coalesce=1)
    fault_mod.install(schedule)
    live, deltas = np.asarray(h.session.edges), []
    try:
        for step in range(epochs):
            upd, w = stream.batch_at(step, live=live)
            res = h.submit(upd, w).result(timeout=600)
            deltas.append(res.deltas[QUERY])
            live = res.advance(live)
    finally:
        fault_mod.clear()
    pool.close()
    return deltas, h.stats, h.session


@pytest.mark.parametrize("spec,retries", [
    ("wal.append@1,wal.fsync@1", 3),  # two failed attempts, then logged
    ("wal.append@1,wal.fsync@1", 1),  # retries exhausted: degrade
    ("snapshot.write@1", 3),  # the cadence skipped, never the commit
])
def test_pool_wal_and_snapshot_faults_match_jax(tmp_path, spec, retries):
    """The same fault schedule in both packages: every epoch commits with
    the JAX pool's delta, ``wal_errors``/``wal_degraded``/``snapshots``
    equal its, and a failed snapshot write leaves the WAL whole, so the
    directory still recovers to the served state."""
    out = {}
    for name, pool, mod in (
            ("t", serve.SessionPool(
                device="cpu", update_batch=64, prewarm=False,
                durable_dir=str(tmp_path / "t"), snapshot_every=2,
                fsync=False, wal_retries=retries, wal_backoff_s=0.0),
             faults),
            ("j", jserve.SessionPool(
                local=True, update_batch=64, prewarm=False,
                durable_dir=str(tmp_path / "j"), snapshot_every=2,
                fsync=False, wal_retries=retries, wal_backoff_s=0.0),
             jfaults)):
        out[name] = _faulted_run(pool, tmp_path / name,
                                 faults.parse_spec(spec), mod)
    (td, ts, tsess), (jd, js, _) = out["t"], out["j"]
    for a, b in zip(td, jd):
        _deltas_equal(a, b)
    keys = ("wal_errors", "wal_degraded", "snapshots", "epochs", "failed",
            "faults_injected")
    assert {k: getattr(ts, k) for k in keys} == \
        {k: getattr(js, k) for k in keys}
    want = {("wal.append@1,wal.fsync@1", 3): (2, False, 2),
            ("wal.append@1,wal.fsync@1", 1): (2, True, 0),
            ("snapshot.write@1", 3): (1, False, 1)}[(spec, retries)]
    assert (ts.wal_errors, ts.wal_degraded, ts.snapshots) == want
    if not ts.wal_degraded:
        again = GraphSession(uniform_graph(24, 160, seed=60), device="cpu",
                             update_batch=64)
        dur = serve.Durability(str(tmp_path / "t" / "a"), again,
                               fsync=False)
        dur.recover()
        dur.close()
        assert again.epoch == tsess.epoch == 5
        np.testing.assert_array_equal(again.edges, tsess.edges)


def test_pool_refuses_what_is_not_ported():
    """The mesh pool is ported: ``local=False`` is four workers on the
    pool's device; a mesh on another device is refused."""
    from repro_torch.launch.mesh import make_host_mesh
    pool = serve.SessionPool(device="cpu", local=False, balance=True)
    assert (pool.local, pool.mesh.num_workers, pool.balance) == \
        (False, 4, True)
    with pytest.raises(ValueError, match="device"):
        serve.SessionPool(device="cpu", mesh=make_host_mesh(2, "meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.SessionPool()


# -- prewarm and compile events -------------------------------------------


@pytest.mark.parametrize("how", ["prewarm()", "prewarm=True"])
def test_prewarm_marks_and_meta_equal_jax(how):
    """After the admission prewarm (called, or run by ``register`` with
    ``prewarm=True``) the ratchet marks and the snapshot meta equal the
    JAX session's, and stay equal over
    epochs; compile events are ints, zero on the CPU."""
    edges = uniform_graph(24, 160, seed=70)
    auto = how == "prewarm=True"
    t = GraphSession(edges, device="cpu", update_batch=64, prewarm=auto)
    j = JSession(edges, local=True, update_batch=64, prewarm=auto)
    for s in (t, j):
        s.register(QUERY)
    if not auto:
        spent = t.prewarm(horizon=64 * 2)
        assert isinstance(spent, int) and spent == 0
        j.prewarm(horizon=64 * 2)
    assert isinstance(t.stats.prewarm_compiles, int)
    assert t.store.ratchet.marks() == j.store.ratchet.marks()
    assert t.store.base_ratchet.marks() == j.store.base_ratchet.marks()
    stream = _stream(7)
    live = t.edges
    for step in range(3):
        upd, w = stream.batch_at(step, live=live)
        a, b = t.update(upd, w), j.update(upd, w)
        assert a.compile_events == 0 and isinstance(a.compile_events, int)
        _deltas_equal(a.deltas[QUERY], b.deltas[QUERY])
        live = a.advance(live)
    (_, tm), (_, jm) = t.snapshot(), j.snapshot()
    tm, jm = (json.loads(json.dumps(m)) for m in (tm, jm))
    tm.pop("stats")
    jm.pop("stats")
    assert tm == jm


def test_library_load_records_one_compile_event(monkeypatch):
    """``_build.lib`` records one event per library it builds or loads,
    before the build (which here has no ``nvcc`` and fails)."""
    def no_nvcc(names, force=False):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "build", no_nvcc)
    monkeypatch.delitem(_build._libs, "fold", raising=False)
    snap = compilestats.snapshot()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.lib("fold")
    assert compilestats.since(snap) == 1
    assert compilestats.counts()["build.fold"] >= 1


# -- the harness, in processes of its own ---------------------------------


def _run_check(extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve._serve_check",
         "--device", "cpu", "--tenants", "2", "--epochs", "8"] + extra,
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["pool", "supervise", "chaos"])
def test_serve_check_modes(mode):
    """Mode A: the pool against isolated oracle sessions; Mode B: a run
    killed right after a WAL append resumes to the uninterrupted run's
    digests; Mode C: a seeded schedule over every point with a caller,
    state equal to the fault-free oracle's."""
    if mode == "pool":
        out = _run_check([])
        assert out["oracle_exact"] and out["serve_compiles"] == 0
    elif mode == "supervise":
        out = _run_check(["--supervise", "--kill-at", "5",
                          "--snapshot-every", "3"])
        assert out["all_exact"] and out["final_exact"] and out["tail_exact"]
        assert out["resume_starts"][out["kill_tenant"]] > 0
        assert out["serve_compiles"] == [0, 0]
    else:
        out = _run_check(["--chaos", "--chaos-rate", "0.1",
                          "--tight-out", "32"])
        assert out["oracle_exact"] and out["accounted"]
        assert out["faults_injected"] > 0
        assert not any(p.startswith("dist.") for p in out["injected"])


def test_serve_check_refuses_workers():
    """``--workers`` above 1 runs on the mesh (``test_torch_mesh_stream``);
    fewer than one worker is refused."""
    from repro_torch.serve import _serve_check
    with pytest.raises(ValueError, match="workers"):
        _serve_check.main(["--workers", "0", "--device", "cpu"])
