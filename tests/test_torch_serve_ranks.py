"""Serving across ranks: the sharded store's snapshot and restore, the WAL
and ``SessionPool`` on a mesh of w = 4 workers over R ranks of
``torch.distributed`` (gloo, on the CPU), against the one-process mesh.

Every job runs in ranks started by ``torch.multiprocessing`` over a
``file://`` store under the test's temporary directory, one torch thread
a rank, as ``tests/test_torch_mesh_ranks.py`` starts them; each rank
writes its results to an ``.npz``.  This process computes the reference
on the one-process mesh first (an uninterrupted session over a seeded
stream, its snapshot at epoch ``K`` and the batches of every epoch, which
the jobs read), then starts every job and the CLI harnesses together.
The jobs that restore a snapshot of another R (``cross``) start when the
jobs that take them (``snap``) end.

A snapshot taken at any R is the one-process snapshot leaf for leaf, and
restores at any other R with each rank holding exactly its workers'
span; the epochs after a restore are the uninterrupted session's, bit for
bit.  The pool on ranks serves every epoch as an isolated one-process
session fed the batches rank 0's WAL logged, outlives an idle spell
longer than the group's timeout, refuses ``submit`` off rank 0, and
survives a failed snapshot write with the older snapshot the newest on
disk.  ``_serve_check``'s three modes and ``launch.serve --stream`` run
under ``torch.distributed.run`` as processes of their own.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp

ROOT = Path(__file__).resolve().parents[1]
W = 4
K = 3  # the epoch every snapshot is taken at
L = 2  # the lockstep epochs after a restore
PG_TIMEOUT_S = 60
IDLE_PG_TIMEOUT_S = 6  # the serve job's group: its idle spell is longer
IDLE_S = 2.5 * IDLE_PG_TIMEOUT_S
JOB_DEADLINE_S = 150
SESSION = dict(batch=256, out_capacity=1 << 14, update_batch=40,
               compact_ratio=0.3)
# a pool's tenants: the sessions' sizes at the pool's compact ratio
TENANT = dict(batch=256, out_capacity=1 << 14, update_batch=40)


# ---------------------------------------------------------------------------
# inputs and helpers (the same in every process)
# ---------------------------------------------------------------------------

def _graph():
    from repro_torch.data.synthetic import uniform_graph
    return uniform_graph(40, 300, 0)


def _session(mesh, edges=None, sizes=SESSION):
    from repro_torch.api import GraphSession
    s = GraphSession(_graph() if edges is None else edges, local=False,
                     mesh=mesh, **sizes)
    s.register("triangle")
    return s


def _save_snap(path, snap):
    leaves, meta = snap
    np.savez(path, meta=np.array(json.dumps(meta)),
             **{f"leaf{i}": a for i, a in enumerate(leaves)})


def _load_snap(path):
    z = np.load(path)
    meta = json.loads(str(z["meta"]))
    return [z[f"leaf{i}"] for i in range(len(meta["names"]))], meta


def _put_snap(out, prefix, snap):
    leaves, meta = snap
    for name, a in zip(meta["names"], leaves):
        out[f"{prefix}/{name}"] = a
    out[f"{prefix}/meta"] = np.array(json.dumps(meta, sort_keys=True))


def _put_local(out, prefix, store):
    """This rank's regions of every snapshot leaf, [wl, ...], named as
    the snapshot names them."""
    for rel in sorted(store._rels):
        st = store._rels[rel]
        for nm in ("lb", "lc_ins", "lc_del"):
            for part, t in store._index_parts(getattr(st, nm)):
                out[f"{prefix}/rel/{rel}/{nm}.{part}"] = t.numpy()
    for i, (_, reg) in enumerate(sorted(store.projections.items(),
                                        key=lambda kv: repr(kv[0]))):
        if reg.derived:
            continue
        for nm in ("d_base", "d_cins", "d_cdel"):
            for part, t in store._index_parts(getattr(reg, nm)):
                out[f"{prefix}/proj/{i}/{nm}.{part}"] = t.numpy()


def _put_delta(out, prefix, d):
    out[f"{prefix}/tuples"] = np.zeros((0, 3), np.int32) \
        if d.tuples is None else np.asarray(d.tuples)
    out[f"{prefix}/weights"] = np.zeros(0, np.int32) \
        if d.weights is None else np.asarray(d.weights)
    out[f"{prefix}/count"] = np.array(d.count_delta)


def _lockstep(out, prefix, s, batches):
    for step in range(K, K + L):
        r = s.update(batches[f"upd{step}"], batches[f"w{step}"])
        _put_delta(out, f"{prefix}/{step}", r.deltas["triangle"])


def _restore_and_run(out, prefix, mesh, tmp, src):
    """Restore the snapshot saved at ``src`` into a session built over
    another graph, keep each rank's regions, run the lockstep epochs and
    keep the final snapshot."""
    batches = np.load(tmp / "batches.npz")
    s = _session(mesh, np.array([[0, 1], [1, 2]], np.int32))
    s.restore(*(_load_snap(src) if mesh.rank == 0 else (None, None)))
    _put_local(out, f"{prefix}/local", s.store)
    out[f"{prefix}/epoch"] = np.array(s.epoch)
    _lockstep(out, prefix, s, batches)
    snap = s.snapshot()
    if mesh.rank == 0:
        _put_snap(out, f"{prefix}/final", snap)
    else:
        out[f"{prefix}/final_none"] = np.array(snap is None)


# ---------------------------------------------------------------------------
# the jobs: fn(mesh, tmp) -> {name: array}
# ---------------------------------------------------------------------------

def job_snap(mesh, tmp):
    """K epochs, the gathered snapshot (saved for the cross jobs), then
    the one-process snapshot restored and the lockstep epochs."""
    from repro_torch.core import exchange
    batches = np.load(tmp / "batches.npz")
    s = _session(mesh)
    for step in range(K):
        s.update(batches[f"upd{step}"], batches[f"w{step}"])
    exchange.reset_counters()
    snap = s.snapshot()
    out = {"bytes": np.array([exchange.EXCHANGE_BYTES[k] for k in
                              ("gather_root", "gather")])}
    if mesh.rank == 0:
        _put_snap(out, "snap", snap)
        _save_snap(tmp / f"snap-{mesh.ranks}.npz", snap)
    else:
        out["snap_none"] = np.array(snap is None)
    exchange.reset_counters()
    _restore_and_run(out, "from1", mesh, tmp, tmp / "snap-1.npz")
    out["restore_bytes"] = np.array(
        [exchange.EXCHANGE_BYTES[k] for k in ("scatter_root",
                                              "broadcast")])
    return out


def job_cross(mesh, tmp):
    """The snapshot of the other R restored here, then the lockstep."""
    other = 4 if mesh.ranks == 2 else 2
    out = {}
    _restore_and_run(out, f"from{other}", mesh, tmp,
                     tmp / f"snap-{other}.npz")
    return out


def _serve_batches(name, n):
    from repro_torch.data.synthetic import EdgeUpdateStream
    stream = EdgeUpdateStream(40, 12, insert_frac=0.5,
                              seed={"a": 5, "b": 6}[name])
    return [stream.batch_at(i) for i in range(n)]


def job_serve(mesh, tmp):
    """A durable pool of two tenants (b coalescing), two serving periods
    with an idle spell of IDLE_S between them inside the first, on a
    group whose timeout is shorter than the spell."""
    from repro_torch.serve import SessionPool
    pool = SessionPool(device="cpu", mesh=mesh, update_batch=40,
                       durable_dir=str(tmp / "serve"), snapshot_every=0,
                       fsync=False)
    for name, coalesce in (("a", 1), ("b", 4)):
        pool.admit(name, _graph(), queries=("triangle",),
                   coalesce=coalesce, **TENANT)
    out = {"idle_s": np.array(pool.idle_s)}
    if mesh.rank != 0:
        try:
            pool.submit("a", np.array([[1, 2]], np.int32))
        except ValueError as e:
            out["refused"] = np.array(str(e))
        pool.drain()
        pool.drain()
    else:
        def serve(lo, hi, idle=0.0):
            ta = [pool.submit("a", *b) for b in _serve_batches("a", hi)[lo:]]
            res = [t.result(timeout=60) for t in ta]
            tb = [pool.submit("b", *b) for b in _serve_batches("b", hi)[lo:]]
            res += [t.result(timeout=60) for t in tb]
            time.sleep(idle)
            for name, r in zip(["a"] * len(ta) + ["b"] * len(tb), res):
                _put_delta(out, f"{name}/{r.epoch}", r.deltas["triangle"])
        t0 = time.monotonic()
        serve(0, 3, IDLE_S)
        out["idle_spell_s"] = np.array(time.monotonic() - t0)
        pool.drain()
        serve(3, 5)
        pool.drain()
    for name in ("a", "b"):
        h = pool.tenant(name)
        out[f"{name}/edges"] = h.session.edges
        out[f"{name}/stats"] = np.array([h.stats.epochs, h.stats.retired,
                                         h.stats.failed, h.session.epoch])
    pool.close()
    return out


def job_fault(mesh, tmp):
    """One tenant, a snapshot every 2 epochs, ``snapshot.write`` failing
    at its second hit (epoch 4): the epoch commits, the snapshot of epoch
    2 stays the newest on disk, and the pool serves on."""
    from repro_torch import faults
    from repro_torch.serve import SessionPool
    d = tmp / "fault"
    pool = SessionPool(device="cpu", mesh=mesh, update_batch=40,
                       durable_dir=str(d), snapshot_every=2, fsync=False,
                       pipeline=False)
    h = pool.admit("a", _graph(), queries=("triangle",), coalesce=1,
                   **TENANT)
    faults.install("snapshot.write@2")
    out = {}
    try:
        for step, (upd, w) in enumerate(_serve_batches("a", 6)):
            if mesh.rank == 0:
                t = h.submit(upd, w)
            pool.pump()
            if mesh.rank == 0:
                r = t.result(timeout=10)
                _put_delta(out, f"a/{r.epoch}", r.deltas["triangle"])
                out[f"ckpt/{r.epoch}"] = np.array(sorted(
                    os.listdir(d / "a" / "ckpt")))
        out["faults"] = np.array([f"{p}@{n}" for p, n in faults.injected()])
    finally:
        faults.clear()
    out["stats"] = np.array([h.stats.snapshots, h.stats.wal_errors,
                             h.stats.epochs, h.session.epoch])
    out["edges"] = h.session.edges
    pool.close()
    return out


JOBS = {"snap": job_snap, "cross": job_cross, "serve": job_serve,
        "fault": job_fault}


def _rank_main(job, rank, ranks, store, out_dir, pg_timeout):
    """One rank of a job (spawned): join the group, run, save."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh
    import repro_torch.api  # noqa: F401  (imported before the group)
    import repro_torch.serve  # noqa: F401
    mesh = init_rank_mesh(W, "gloo", "cpu", rank=rank, ranks=ranks,
                          init_method=f"file://{store}",
                          timeout_s=pg_timeout)
    out = JOBS[job](mesh, Path(out_dir))
    np.savez(Path(out_dir) / f"{job}-{ranks}-{rank}.npz", **out)
    close_rank_mesh()


class _Job:
    """The R spawned ranks of one job."""

    def __init__(self, job, ranks, tmp, pg_timeout=PG_TIMEOUT_S):
        ctx = tmp_mp.get_context("spawn")
        store = tmp / f"{job}-{ranks}.store"
        self.job, self.ranks, self.tmp = job, ranks, tmp
        self.t0 = time.monotonic()
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(job, r, ranks, str(store), str(tmp),
                                        pg_timeout), daemon=True)
                      for r in range(ranks)]
        for p in self.procs:
            p.start()

    def results(self, deadline_s=JOB_DEADLINE_S):
        """Every rank's results, once all ended with 0: the first rank to
        fail, or the deadline, kills the rest and fails the test."""
        while True:
            codes = [p.exitcode for p in self.procs]
            if all(c is not None for c in codes):
                break
            if any(c not in (None, 0) for c in codes) or \
                    time.monotonic() - self.t0 > deadline_s:
                for p in self.procs:
                    if p.exitcode is None:
                        p.kill()
                for p in self.procs:
                    p.join(10)
                break
            time.sleep(0.05)
        self.codes = [p.exitcode for p in self.procs]
        assert self.codes == [0] * self.ranks, (self.job, self.ranks,
                                                self.codes)
        return [dict(np.load(self.tmp / f"{self.job}-{self.ranks}-{r}.npz"))
                for r in range(self.ranks)]


def _torchrun(*argv):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2"] + list(argv)


CHECK = ["--device", "cpu", "--workers", "4", "--tenants", "2"]
HARNESSES = {
    "pool": _torchrun("-m", "repro_torch.serve._serve_check", "--backend",
                      "gloo", *CHECK, "--epochs", "6"),
    "supervise": [sys.executable, "-m", "repro_torch.serve._serve_check",
                  "--supervise", "--backend", "gloo", "--ranks", "2",
                  *CHECK, "--epochs", "6", "--kill-at", "4",
                  "--snapshot-every", "3"],
    "chaos": _torchrun("-m", "repro_torch.serve._serve_check", "--backend",
                       "gloo", *CHECK, "--epochs", "8", "--chaos",
                       "--chaos-rate", "0.1", "--tight-out", "32"),
    "stream": _torchrun("-m", "repro_torch.launch.serve", "--stream",
                        "--workers", "4", "--backend", "gloo", "--device",
                        "cpu", "--scale", "6", "--epochs", "3",
                        "--batch-size", "32", "--bprime", "256",
                        "--out-capacity", "16384", "--verify",
                        "--snapshot-every", "2", "--durable-dir"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(tmp):
    """The one-process mesh: every batch of K + L epochs, each epoch's
    delta, the snapshot at K (saved for the jobs) and the final one;
    no collective may be called."""
    import contextlib
    from unittest import mock
    import torch.distributed as dist
    from repro_torch.data.synthetic import EdgeUpdateStream
    from repro_torch.launch.mesh import make_host_mesh
    ref, batches = {}, {}
    with contextlib.ExitStack() as stack:
        for name in ("all_to_all_single", "all_reduce", "all_gather",
                     "gather", "scatter", "broadcast"):
            stack.enter_context(mock.patch.object(
                dist, name, side_effect=AssertionError(name)))
        s = _session(make_host_mesh(W, "cpu"))
        stream = EdgeUpdateStream(40, 40, seed=1)
        live = _graph()
        for step in range(K + L):
            if step == K:
                snap = s.snapshot()
                _save_snap(tmp / "snap-1.npz", snap)
                _put_snap(ref, "snap", snap)
            upd, w = stream.batch_at(step, live=live)
            batches[f"upd{step}"], batches[f"w{step}"] = upd, w
            r = s.update(upd, w)
            _put_delta(ref, f"lock/{step}", r.deltas["triangle"])
            live = r.advance(live)
        _put_snap(ref, "final", s.snapshot())
    np.savez(tmp / "batches.npz", **batches)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_ranks")
    ref = _reference(tmp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    procs = {}
    for name, argv in HARNESSES.items():
        if name == "stream":
            argv = argv + [str(tmp / "stream")]
        procs[name] = subprocess.Popen(
            argv, env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    jobs = {("snap", 2): _Job("snap", 2, tmp),
            ("snap", 4): _Job("snap", 4, tmp),
            ("serve", 2): _Job("serve", 2, tmp, IDLE_PG_TIMEOUT_S),
            ("fault", 2): _Job("fault", 2, tmp)}
    out = {"ref": ref, "tmp": tmp}
    for R in (2, 4):
        out[("snap", R)] = jobs[("snap", R)].results()
    cross = {R: _Job("cross", R, tmp) for R in (2, 4)}
    # the one-process mesh restores the ranked snapshots meanwhile
    from repro_torch.launch.mesh import make_host_mesh
    batches = np.load(tmp / "batches.npz")
    for R in (2, 4):
        s = _session(make_host_mesh(W, "cpu"), np.array([[0, 1]], np.int32))
        s.restore(*_load_snap(tmp / f"snap-{R}.npz"))
        got = {}
        _lockstep(got, f"one/from{R}", s, batches)
        _put_snap(got, f"one/from{R}/final", s.snapshot())
        out[("one", R)] = got
    for key in (("serve", 2), ("fault", 2)):
        out[key] = jobs[key].results()
    for R in (2, 4):
        out[("cross", R)] = cross[R].results()
    for name, p in procs.items():
        so, se = p.communicate(timeout=2 * JOB_DEADLINE_S)
        out[name] = (p.returncode, so, se)
    return out


def _span(R, rank):
    from repro_torch.launch.mesh import WorkerMesh
    return WorkerMesh(W, "cpu", R, rank, "gloo").span


def _snaps_equal(got, want, gp, wp):
    """The snapshot under ``gp`` of ``got`` leaf for leaf (dtype, shape,
    bits) and meta for meta the one under ``wp`` of ``want``."""
    assert str(got[f"{gp}/meta"]) == str(want[f"{wp}/meta"])
    names = json.loads(str(want[f"{wp}/meta"]))["names"]
    for name in names:
        a, b = got[f"{gp}/{name}"], want[f"{wp}/{name}"]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        np.testing.assert_array_equal(a, b, err_msg=name)
    return len(names)


def _deltas_equal(got, want, gp, wp, epochs):
    for step in epochs:
        for part in ("tuples", "weights", "count"):
            np.testing.assert_array_equal(got[f"{gp}/{step}/{part}"],
                                          want[f"{wp}/{step}/{part}"],
                                          err_msg=f"{gp} {step} {part}")


# ---------------------------------------------------------------------------
# snapshots and restores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [2, 4])
def test_gathered_snapshot_is_the_one_process_snapshot(runs, R):
    """Rank 0's gathered snapshot at epoch K: the one-process mesh's, leaf
    for leaf ([w] leaves, the same names and meta); the other ranks get
    None."""
    root, *others = runs[("snap", R)]
    assert _snaps_equal(root, runs["ref"], "snap", "snap") > 10
    assert all(bool(o["snap_none"]) for o in others)


@pytest.mark.parametrize("R", [2, 4])
def test_snapshot_gathers_each_rank_s_rows_once(runs, R):
    """A rank other than 0 hands rank 0 its rows of every leaf once, 1/R
    of the snapshot's bytes; rank 0 sends none.  Every rank sends its
    meta digest to the others (one int64 a rank)."""
    ref = runs["ref"]
    names = json.loads(str(ref["snap/meta"]))["names"]
    total = sum(ref[f"snap/{n}"].nbytes for n in names)
    for rank, got in enumerate(runs[("snap", R)]):
        rows, digest = got["bytes"].tolist()
        assert rows == (0 if rank == 0 else total // R)
        assert digest == 8 * (R - 1)


@pytest.mark.parametrize("R", [2, 4])
def test_one_process_snapshot_restores_at_R(runs, R):
    """The one-process snapshot restored at R: each rank holds exactly its
    workers' span of every leaf, the epoch is K, and the lockstep epochs
    are the uninterrupted session's, bit for bit; rank 0 scatters each
    leaf's other spans once and broadcasts the meta."""
    ref = runs["ref"]
    names = json.loads(str(ref["snap/meta"]))["names"]
    for rank, got in enumerate(runs[("snap", R)]):
        lo, hi = _span(R, rank)
        for name in names:
            a, want = got[f"from1/local/{name}"], ref[f"snap/{name}"][lo:hi]
            assert (a.dtype, a.shape) == (want.dtype, want.shape), name
            np.testing.assert_array_equal(a, want, err_msg=name)
        assert int(got["from1/epoch"]) == K
        _deltas_equal(got, ref, "from1", "lock", range(K, K + L))
        scatter, _ = got["restore_bytes"].tolist()
        total = sum(ref[f"snap/{n}"].nbytes for n in names)
        assert scatter == (total * (R - 1) // R if rank == 0 else 0)
    _snaps_equal(runs[("snap", R)][0], ref, "from1/final", "final")


@pytest.mark.parametrize("R", [2, 4])
def test_ranked_snapshot_restores_at_the_other_R(runs, R):
    """The snapshot gathered at R restored at the other R (2 <-> 4), and
    in one process: the regions, the lockstep epochs and the final
    snapshot are the uninterrupted session's."""
    ref = runs["ref"]
    names = json.loads(str(ref["snap/meta"]))["names"]
    other = 4 if R == 2 else 2
    for rank, got in enumerate(runs[("cross", other)]):
        lo, hi = _span(other, rank)
        for name in names:
            np.testing.assert_array_equal(got[f"from{R}/local/{name}"],
                                          ref[f"snap/{name}"][lo:hi])
        _deltas_equal(got, ref, f"from{R}", "lock", range(K, K + L))
    _snaps_equal(runs[("cross", other)][0], ref, f"from{R}/final", "final")
    one = runs[("one", R)]
    _deltas_equal(one, ref, f"one/from{R}", "lock", range(K, K + L))
    _snaps_equal(one, ref, f"one/from{R}/final", "final")


# ---------------------------------------------------------------------------
# the pool and the WAL on ranks
# ---------------------------------------------------------------------------

def _wal_records(path):
    from repro_torch.serve.wal import WriteAheadLog
    return list(WriteAheadLog(str(path), fsync=False).replay())


def test_pool_on_ranks_serves_the_wal_s_batches(runs):
    """Every epoch of both tenants (b coalescing up to 4 batches) equals
    an isolated one-process session fed the batches rank 0's WAL logged;
    every rank ends with the same live edges and counters, and every
    submitted batch retired."""
    from repro_torch.launch.mesh import make_host_mesh
    r0, r1 = runs[("serve", 2)]
    for name in ("a", "b"):
        recs = _wal_records(runs["tmp"] / "serve" / name / "wal.log")
        iso = _session(make_host_mesh(W, "cpu"), sizes=TENANT)
        for epoch, batches in recs:
            d = iso.update(batches).deltas["triangle"]
            np.testing.assert_array_equal(
                r0[f"{name}/{epoch}/count"], d.count_delta)
            np.testing.assert_array_equal(
                r0[f"{name}/{epoch}/tuples"],
                np.zeros((0, 3), np.int32) if d.tuples is None
                else d.tuples)
        assert [e for e, _ in recs] == list(range(1, len(recs) + 1))
        np.testing.assert_array_equal(iso.edges, r0[f"{name}/edges"])
        np.testing.assert_array_equal(r1[f"{name}/edges"],
                                      r0[f"{name}/edges"])
        assert r0[f"{name}/stats"].tolist() == r1[f"{name}/stats"].tolist()
        epochs, retired, failed, epoch = r0[f"{name}/stats"].tolist()
        assert (retired, failed, epoch) == (5, 0, len(recs)) and \
            epochs == len(recs)
    assert r0["a/stats"][0] == 5  # coalesce 1: an epoch a batch


def test_idle_pool_outlives_the_group_timeout(runs):
    """Rank 0 idles longer than the group's timeout inside a serving
    period; its idle records keep rank 1 alive, and both periods end."""
    r0, r1 = runs[("serve", 2)]
    assert float(r0["idle_spell_s"]) > IDLE_PG_TIMEOUT_S * 2
    assert float(r0["idle_s"]) == float(r1["idle_s"]) == \
        IDLE_PG_TIMEOUT_S / 4


def test_submit_off_rank_0_is_refused(runs):
    _, r1 = runs[("serve", 2)]
    msg = str(r1["refused"])
    assert "rank 1" in msg and "rank 0" in msg


def test_failed_snapshot_write_leaves_the_older_snapshot_newest(runs):
    """``snapshot.write`` fails at epoch 4 on rank 0: epoch 4 commits on
    both ranks, epoch 2's snapshot stays the newest on disk (no partial
    one), the cadence resumes at epoch 6, and the directory recovers in
    one process to the served state."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.wal import Durability
    r0, r1 = runs[("fault", 2)]
    assert r0["faults"].tolist() == ["snapshot.write@2"]
    listed = {e: r0[f"ckpt/{e}"].tolist() for e in range(1, 7)}
    assert listed[3] == listed[4] == listed[5] == ["ckpt_0000000002"]
    assert listed[6] == ["ckpt_0000000002", "ckpt_0000000006"]
    for got in (r0, r1):
        # snapshots, wal_errors, epochs, session epoch
        assert got["stats"].tolist() == [2, 1, 6, 6]
        np.testing.assert_array_equal(got["edges"], r0["edges"])
    s = _session(make_host_mesh(W, "cpu"), np.array([[0, 1]], np.int32),
                 TENANT)
    d = Durability(str(runs["tmp"] / "fault" / "a"), s)
    assert d.recover()
    d.close()
    assert s.epoch == 6
    np.testing.assert_array_equal(s.edges, r0["edges"])


# ---------------------------------------------------------------------------
# the harnesses under torch.distributed.run
# ---------------------------------------------------------------------------

def _one_line(runs, name):
    rc, so, se = runs[name]
    assert rc == 0, so[-2000:] + se[-4000:]
    lines = [ln for ln in so.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, so  # rank 0 prints, and only it
    return json.loads(lines[0])


def test_serve_check_pool_on_ranks(runs):
    out = _one_line(runs, "pool")
    assert (out["ranks"], out["backend"], out["workers"]) == (2, "gloo", 4)
    assert out["oracle_exact"] and out["serve_compiles"] == 0


def test_serve_check_supervise_on_ranks(runs):
    """A job killed right after rank 0's WAL append, then a resumed job:
    the uninterrupted job's digests and final state."""
    out = _one_line(runs, "supervise")
    assert (out["ranks"], out["backend"]) == (2, "gloo")
    assert out["all_exact"] and out["final_exact"] and out["tail_exact"]
    assert out["resume_starts"][out["kill_tenant"]] > 0


def test_serve_check_chaos_on_ranks(runs):
    """A seeded schedule over all eight points, every rank firing the
    ones it passes: the fault-free oracles' state, every batch
    accounted."""
    out = _one_line(runs, "chaos")
    assert (out["ranks"], out["backend"]) == (2, "gloo")
    assert out["oracle_exact"] and out["accounted"]
    assert out["faults_injected"] > 0
    fired = {p.split("@")[0] for p in out["injected"]}
    assert "dist.program" in fired and "pool.apply" in fired


def test_launch_serve_stream_on_ranks(runs):
    rc, so, se = runs["stream"]
    assert rc == 0, so[-2000:] + se[-4000:]
    assert "over 2 gloo ranks" in so
    assert so.count("verified triangle") == 1  # rank 0 prints
    snaps = os.listdir(runs["tmp"] / "stream" / "stream" / "ckpt")
    assert snaps == ["ckpt_0000000002"]


def test_supervise_refuses_to_run_inside_a_job(monkeypatch):
    from repro_torch.serve import _serve_check
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="plain process"):
        _serve_check.main(["--supervise", "--backend", "gloo",
                           "--workers", "4", "--device", "cpu"])


def test_backend_needs_a_mesh():
    from repro_torch.launch import serve
    from repro_torch.serve import _serve_check
    for main in (_serve_check.main, serve.main):
        with pytest.raises(SystemExit):
            main(["--backend", "gloo", "--workers", "1", "--device", "cpu",
                  "--stream"] if main is serve.main else
                 ["--backend", "gloo", "--workers", "1", "--device", "cpu"])
