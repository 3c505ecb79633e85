"""The port's mesh across processes: w = 4 workers over R ranks of
``torch.distributed`` (gloo, on the CPU), against the one-process mesh and
the JAX package's mesh.

Every job runs in ranks started by ``torch.multiprocessing`` over a
``file://`` store under the test's temporary directory, one torch thread
a rank, with a process-group timeout of at most 60 s and a deadline on
the whole job: a rank that deadlocks or dies fails its job within those
bounds (the first rank to fail ends the others).  Each rank writes its
results to an ``.npz``; the same job function run in this process on the
one-process mesh (``make_host_mesh``) is the reference.  Results under
``w/`` have a leading axis of the w workers, and each rank must hold
exactly its workers' rows of the reference; every other result must be
the reference's on every rank, bit for bit.

One JAX subprocess with four host devices, started beside the ranks,
computes the static triangle join and a 3-epoch triangle stream on the
same seeded inputs; the ranked port must equal it exactly.  The CLI
harnesses run under ``python -m torch.distributed.run --nproc-per-node
2`` as processes of their own.
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
PG_TIMEOUT_S = 60  # every collective of a job's process group
JOB_DEADLINE_S = 150  # a whole job, its ranks' start included
STALL_TIMEOUT_S = 5  # the process-group timeout of the deadlock jobs

# the static joins: name -> (query, relation, route capacity, balance).
# A route of 8 slots defers most requests to later rounds.
STATIC = {
    "triangle": ("triangle", "edge", 64, False),
    "triangle-balance": ("triangle", "edge", 64, True),
    "triangle-defer": ("triangle", "edge", 8, False),
    "4-clique-tri": ("4-clique-tri", "tri", 64, False),
}
STREAM_EPOCHS = 4  # engine and session; the JAX stream runs the first 3
JAX_EPOCHS = 3


# ---------------------------------------------------------------------------
# inputs, made from a seed with numpy (the same on every rank)
# ---------------------------------------------------------------------------

def _static_edges():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 60, 500)
    v = rng.integers(0, 60, 500)
    keep = u != v
    return np.unique(np.stack([u[keep], v[keep]], 1).astype(np.int32),
                     axis=0)


def _relations(rel):
    from repro_torch.core import query as Q
    from repro_torch.core.generic_join import generic_join
    e = _static_edges()
    if rel == "tri":
        tri, _ = generic_join(Q.triangle(), {Q.EDGE: e[e[:, 0] < 40]})
        return {"tri": np.asarray(tri, np.int32)}
    return {Q.EDGE: e}


def _stream():
    from repro_torch.data.synthetic import EdgeUpdateStream, uniform_graph
    return uniform_graph(40, 300, 0), EdgeUpdateStream(40, 40, seed=1)


# ---------------------------------------------------------------------------
# the jobs: fn(mesh) -> {name: array}; run on a rank mesh or, for the
# reference, on the one-process mesh
# ---------------------------------------------------------------------------

def _put_index(out, prefix, d):
    for part in ("key", "val", "n", "lo"):
        t = getattr(d, part)
        if t is not None:
            out[f"w/{prefix}.{part}"] = t.cpu().numpy()


def _put_store(out, prefix, store):
    """Every device region of a sharded store, [wl, cap] each."""
    for rel in sorted(store._rels):
        st = store._rels[rel]
        for nm in ("lb", "lc_ins", "lc_del"):
            _put_index(out, f"{prefix}/{rel}/{nm}", getattr(st, nm))
    for i, key in enumerate(sorted(store.projections, key=repr)):
        reg = store.projections[key]
        if not reg.derived:
            for nm in ("d_base", "d_cins", "d_cdel"):
                _put_index(out, f"{prefix}/proj{i}/{nm}", getattr(reg, nm))
    for nm in ("compactions", "live_compactions", "escalations", "epochs"):
        out[f"{prefix}/stats/{nm}"] = np.array(getattr(store.stats, nm))


def _put_delta(out, prefix, d, m=3):
    out[f"{prefix}/tuples"] = np.zeros((0, m), np.int32) \
        if d.tuples is None else np.asarray(d.tuples)
    out[f"{prefix}/weights"] = np.zeros(0, np.int32) \
        if d.weights is None else np.asarray(d.weights)
    out[f"{prefix}/stats"] = np.array(
        [d.count_delta] + [x for r in d.per_dq for x in
                           (r.count, r.proposals, r.intersections,
                            r.steps)], np.int64)


def _buffers():
    """(cap, send buffers [w, w·cap, ...]) of the exchange checks."""
    rng = np.random.default_rng(7)
    out = []
    for cap, tail, dt in ((3, (), np.int32), (2, (3,), np.int64),
                          (5, (2,), np.int32)):
        x = rng.integers(-2 ** 30, 2 ** 30, (W, W * cap) + tail)
        out.append((cap, x.astype(dt)))
    return out


def job_exchanges(mesh):
    from repro_torch.core import exchange
    from repro_torch.core.distributed import remote_service
    lo, hi = mesh.span
    out = {}
    exchange.reset_counters()
    for i, (_, x) in enumerate(_buffers()):
        xt = torch.from_numpy(x[lo:hi])
        out[f"w/a2a/{i}"] = exchange.all_to_all(xt, mesh).numpy()
        out[f"psum/{i}"] = exchange.psum(xt, mesh).numpy()
        out[f"pmax/{i}"] = exchange.pmax(xt, mesh).numpy()
    out["r/bytes/exchanges"] = np.array(
        [exchange.EXCHANGE_BYTES[k] for k in ("all_to_all", "psum", "pmax")])
    # one service call: an int64 key and an int32 value a request, an
    # int32 reply (the owner's global id plus both words)
    rng = np.random.default_rng(11)
    B, cap = 24, 8
    key = rng.integers(0, 1 << 40, (W, B))
    val = rng.integers(0, 1 << 20, (W, B)).astype(np.int32)
    dest = rng.integers(0, W, (W, B)).astype(np.int32)
    valid = rng.random((W, B)) < 0.8
    exchange.reset_counters()

    def reply(o, q):
        return ((q[0] % 1000).to(torch.int32) + q[1] + 7 * (lo + o),)

    (rep,), ok, load = remote_service(
        (torch.from_numpy(key[lo:hi]), torch.from_numpy(val[lo:hi])),
        torch.from_numpy(dest[lo:hi]), torch.from_numpy(valid[lo:hi]),
        reply, W, cap, mesh)
    out["w/service/reply"] = torch.where(ok, rep, -1).numpy()
    out["w/service/ok"] = ok.numpy()
    out["w/service/load"] = load.numpy()
    out["r/bytes/service"] = np.array(exchange.EXCHANGE_BYTES["all_to_all"])
    return out


def job_static(mesh):
    from repro_torch.core import exchange
    from repro_torch.core import query as Q
    from repro_torch.core.bigjoin import BigJoinConfig
    from repro_torch.core.distributed import (DistConfig, distributed_join,
                                              partition_indices,
                                              step_exchange_bytes)
    from repro_torch.core.plan import make_plan
    out = {}
    for name, (qn, rel, route, balance) in STATIC.items():
        rels = _relations(rel)
        plan = make_plan(Q.query_by_name(qn))
        cfg = DistConfig(BigJoinConfig(batch=256, mode="collect",
                                       out_capacity=1 << 14), W,
                         route_capacity=route, balance=balance)
        indices = partition_indices(plan, rels, W, device="cpu", mesh=mesh)
        for iid in sorted(indices):
            for j, d in enumerate(indices[iid].pos):
                _put_index(out, f"{name}/index/{iid}/{j}", d)
        # the bytes counted from one step's start to the next's: its
        # services and the next step's psum of the queue sizes
        at = []

        def hook(i, run):
            at.append(sum(exchange.EXCHANGE_BYTES.values()))
            return run()
        exchange.reset_counters()
        r = distributed_join(plan, rels, mesh=mesh, cfg=cfg,
                             indices=indices, step_hook=hook)
        if len(plan.levels) == 1 and not balance:
            out[f"r/step_bytes/{name}"] = np.diff(at)
            out[f"r/step_model/{name}"] = np.array(step_exchange_bytes(
                plan, cfg, indices, 0, mesh.ranks))
        out[f"{name}/scalars"] = np.array(
            [r.count, r.proposals, r.intersections, r.steps, r.max_load,
             r.mean_load], np.float64)
        out[f"{name}/tuples"] = r.tuples
        out[f"{name}/weights"] = r.weights
        out[f"{name}/worker_rows"] = r.worker_rows
    return out


def job_engine(mesh):
    """DistDeltaBigJoin over a triangle stream through compactions."""
    from repro_torch.core import query as Q
    from repro_torch.core.distributed import (DistDeltaBigJoin,
                                              default_delta_config)
    e, stream = _stream()
    eng = DistDeltaBigJoin(
        Q.triangle(), e, mesh=mesh,
        dcfg=default_delta_config(W, batch=256, out_capacity=1 << 14),
        compact_ratio=0.3)
    out, live = {}, e
    for step in range(STREAM_EPOCHS):
        upd, w = stream.batch_at(step, live=live)
        _put_delta(out, f"engine/{step}", eng.apply(upd, w))
        _put_store(out, f"engine/{step}/store", eng.store)
        live = eng.store.edges.copy()
        out[f"engine/{step}/edges"] = live
        if step == JAX_EPOCHS - 1:
            # the store gathered to rank 0 at the JAX stream's end
            snap = eng.store.snapshot()
            if mesh.rank == 0:
                leaves, meta = snap
                out["r/snap/meta"] = np.array(json.dumps(meta,
                                                         sort_keys=True))
                for name, leaf in zip(meta["names"], leaves):
                    out[f"r/snap/{name}"] = leaf
    return out


def job_session(mesh):
    """The mesh session over the same stream, with a ``dist.program``
    fault at the second run: the update rolls back and is applied
    again."""
    from repro_torch import faults
    from repro_torch.api import GraphSession
    from repro_torch.errors import FaultInjected
    e, stream = _stream()
    s = GraphSession(e, local=False, mesh=mesh, batch=256,
                     out_capacity=1 << 14, update_batch=40,
                     compact_ratio=0.3)
    h = s.register("triangle")
    out, live = {}, e
    faults.install("dist.program@2")
    try:
        for step in range(STREAM_EPOCHS):
            upd, w = stream.batch_at(step, live=live)
            try:
                r = s.update(upd, w)
            except FaultInjected:
                out[f"session/{step}/faulted"] = np.array(1)
                r = s.update(upd, w)
            _put_delta(out, f"session/{step}", r.deltas["triangle"])
            _put_store(out, f"session/{step}/store", s.store)
            live = r.advance(live)
    finally:
        faults.clear()
    out["session/count"] = np.array(h.count())
    t, wt = h.enumerate()
    out["session/enum/tuples"], out["session/enum/weights"] = t, wt
    out["session/epoch"] = np.array(s.epoch)
    return out


def job_joins(mesh):
    """R = 4: the exchanges, the static joins and the engine stream (one
    worker a rank: the store's regions are [1, cap])."""
    out = job_exchanges(mesh)
    out.update(job_static(mesh))
    out.update(job_engine(mesh))
    return out


def job_all(mesh):
    out = job_joins(mesh)
    out.update(job_session(mesh))
    return out


def job_crash(mesh):
    from repro_torch.core import exchange
    if mesh.rank == 1:
        raise RuntimeError("rank 1 dies before the collective")
    exchange.psum(torch.ones((mesh.local_workers, 1), dtype=torch.int64),
                  mesh)
    return {}


def job_stall(mesh):
    from repro_torch.core import exchange
    if mesh.rank == 1:
        time.sleep(10 * JOB_DEADLINE_S)  # never joins the collective
    exchange.psum(torch.ones((mesh.local_workers, 1), dtype=torch.int64),
                  mesh)
    return {}


def job_from_jax(mesh):
    """The JAX engine's store snapshot (``jax.npz``, after the JAX stream's
    epochs) restored into a ranked engine built over one edge, then the
    stream's next epoch."""
    from repro_torch.core import query as Q
    from repro_torch.core.distributed import (DistDeltaBigJoin,
                                              default_delta_config)
    jax = np.load(OUT_DIR[0] / "jax.npz")
    meta = json.loads(str(jax["snap/meta"]))
    leaves = [jax[f"snap/{n}"] for n in meta["names"]]
    eng = DistDeltaBigJoin(
        Q.triangle(), np.array([[0, 1]], np.int32), mesh=mesh,
        dcfg=default_delta_config(W, batch=256, out_capacity=1 << 14),
        compact_ratio=0.3)
    if mesh.rank == 0:
        eng.store.restore(leaves, meta)
    else:
        eng.store.restore(None, None)
    out = {}
    _put_store(out, "restored", eng.store)
    _, stream = _stream()
    upd, w = stream.batch_at(JAX_EPOCHS, live=eng.store.edges)
    _put_delta(out, "next", eng.apply(upd, w))
    return out


JOBS = {"all": job_all, "joins": job_joins, "crash": job_crash,
        "stall": job_stall, "from-jax": job_from_jax}
OUT_DIR = [None]  # a rank's output directory, for the jobs that read one


def _rank_main(job, rank, ranks, store, out_dir, pg_timeout):
    """One rank of a job (spawned): join the group, run, save."""
    torch.set_num_threads(1)
    OUT_DIR[0] = Path(out_dir)
    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh
    mesh = init_rank_mesh(W, "gloo", "cpu", rank=rank, ranks=ranks,
                          init_method=f"file://{store}",
                          timeout_s=pg_timeout)
    out = JOBS[job](mesh)
    np.savez(Path(out_dir) / f"{job}-{ranks}-{rank}.npz", **out)
    close_rank_mesh()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

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

    def wait(self, deadline_s=JOB_DEADLINE_S):
        """Exit codes, once every rank ended: the first rank to fail, or
        the deadline, kills the rest (a killed rank's code is negative).
        Sets ``seconds``, the job's time from its start."""
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
        self.seconds = time.monotonic() - self.t0
        self.codes = [p.exitcode for p in self.procs]
        assert not any(p.is_alive() for p in self.procs)
        return self.codes

    def results(self):
        assert self.wait() == [0] * self.ranks, (self.job, self.codes)
        return [dict(np.load(self.tmp / f"{self.job}-{self.ranks}-{r}.npz"))
                for r in range(self.ranks)]


_JAX_RUNNER = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core import distributed as D
from repro.core import query as Q
from repro.core.bigjoin import BigJoinConfig
from repro.core.plan import make_plan
from repro.data.synthetic import EdgeUpdateStream, uniform_graph

out_path, epochs = sys.argv[1], int(sys.argv[2])
res = {}
rng = np.random.default_rng(0)
u = rng.integers(0, 60, 500)
v = rng.integers(0, 60, 500)
keep = u != v
e = np.unique(np.stack([u[keep], v[keep]], 1).astype(np.int32), axis=0)
cfg = D.DistConfig(BigJoinConfig(batch=256, mode="collect",
                                 out_capacity=1 << 14, use_kernel=False),
                   4, route_capacity=64)
r = D.distributed_join(make_plan(Q.triangle()), {Q.EDGE: e}, cfg=cfg)
res["static/scalars"] = np.array([r.count, r.proposals, r.intersections,
                                  r.steps, r.max_load, r.mean_load],
                                 np.float64)
res["static/tuples"], res["static/weights"] = r.tuples, r.weights

mesh = Mesh(np.array(jax.devices()[:4]), (D.AXIS,))
e = uniform_graph(40, 300, 0)
stream = EdgeUpdateStream(40, 40, seed=1)
eng = D.DistDeltaBigJoin(
    Q.triangle(), e, mesh=mesh,
    dcfg=D.default_delta_config(4, batch=256, out_capacity=1 << 14,
                                use_kernel=False), compact_ratio=0.3)
live = e
for step in range(epochs):
    upd, w = stream.batch_at(step, live=live)
    res[f"{step}/upd"], res[f"{step}/w"] = upd, w
    d = eng.apply(upd, w)
    res[f"{step}/tuples"] = np.zeros((0, 3), np.int32) \
        if d.tuples is None else np.asarray(d.tuples, np.int32)
    res[f"{step}/weights"] = np.zeros(0, np.int32) \
        if d.weights is None else np.asarray(d.weights, np.int32)
    res[f"{step}/stats"] = np.array(
        [d.count_delta] + [x for q in d.per_dq for x in
                           (q.count, q.proposals, q.intersections, q.steps)],
        np.int64)
    live = eng.edges.copy()
leaves, meta = eng.store.snapshot()
res["snap/meta"] = np.array(json.dumps(meta, sort_keys=True))
for name, leaf in zip(meta["names"], leaves):
    res[f"snap/{name}"] = np.asarray(leaf)
np.savez(out_path, **res)
"""

# the CLI harnesses under torch.distributed.run, and the NCCL refusal
HARNESSES = {
    "dist-check": ["-m", "torch.distributed.run", "--standalone",
                   "--nproc-per-node", "2", "-m",
                   "repro_torch.core._dist_check", "--backend", "gloo",
                   "--device", "cpu", "--workers", "4", "--batch", "256",
                   "--route-capacity", "64"],
    "delta-check": ["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", "2", "-m",
                    "repro_torch.core._delta_dist_check", "--backend",
                    "gloo", "--device", "cpu", "--workers", "4",
                    "--batches", "3"],
    "nccl-refused": ["-m", "repro_torch.core._dist_check", "--backend",
                     "nccl", "--workers", "4"],
    "dist-rmat": ["-m", "repro_torch.core._dist_check", "--device", "cpu",
                  "--workers", "4", "--rmat-scale", "7", "--batch", "256",
                  "--route-capacity", "256", "--out-capacity", "65536"],
    "dist-rmat-unchecked": ["-m", "repro_torch.core._dist_check",
                            "--device", "cpu", "--workers", "4",
                            "--rmat-scale", "7", "--batch", "256",
                            "--route-capacity", "256", "--out-capacity",
                            "65536", "--no-check"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job, the JAX process and the harnesses started together; the
    references computed here meanwhile."""
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", REPRO_MERGE_KERNEL="0",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=4")
    procs = {"jax": subprocess.Popen(
        [sys.executable, "-c", _JAX_RUNNER, str(tmp / "jax.npz"),
         str(JAX_EPOCHS)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)}
    cli_env = dict(env, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    for name, argv in HARNESSES.items():
        procs[name] = subprocess.Popen(
            [sys.executable] + argv, env=cli_env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jobs = {("all", 2): _Job("all", 2, tmp),
            ("joins", 4): _Job("joins", 4, tmp),
            ("crash", 2): _Job("crash", 2, tmp),
            ("stall", 2): _Job("stall", 2, tmp, STALL_TIMEOUT_S)}
    import contextlib
    from unittest import mock
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    # the one-process mesh calls no collective: each would raise here
    with contextlib.ExitStack() as stack:
        for name in ("all_to_all_single", "all_reduce", "all_gather"):
            stack.enter_context(mock.patch.object(
                dist, name, side_effect=AssertionError(name)))
        ref = job_all(make_host_mesh(W, "cpu"))
    out = {"ref": ref, "jobs": jobs}
    for key in (("crash", 2), ("stall", 2)):
        jobs[key].wait()
    out[2] = jobs[("all", 2)].results()
    out[4] = jobs[("joins", 4)].results()
    for name, p in procs.items():
        so, se = p.communicate(timeout=2 * JOB_DEADLINE_S)
        out[name] = (p.returncode, so, se)
    rc, _, se = out["jax"]
    assert rc == 0, se[-4000:]
    out["jax"] = dict(np.load(tmp / "jax.npz"))
    out["from-jax"] = _Job("from-jax", 2, tmp).results()
    return out


def _held(got: dict, ref: dict, lo: int, hi: int, prefix: str) -> int:
    """Every result under ``prefix`` of one rank against the reference:
    the rank's workers' rows of a ``w/`` result, all of any other.
    Returns the number compared."""
    keys = [k for k in ref if k.startswith(prefix)
            or k.startswith("w/" + prefix)]
    assert keys, prefix
    for k in keys:
        want = ref[k][lo:hi] if k.startswith("w/") else ref[k]
        a = got[k]
        assert (a.dtype, a.shape) == (want.dtype, want.shape), k
        np.testing.assert_array_equal(a, want, err_msg=k)
    return len(keys)


def _each_rank(runs, R, prefix):
    from repro_torch.launch.mesh import WorkerMesh
    for rank, got in enumerate(runs[R]):
        lo, hi = WorkerMesh(W, "cpu", R, rank, "gloo").span
        _held(got, runs["ref"], lo, hi, prefix)


# ---------------------------------------------------------------------------
# the exchanges
# ---------------------------------------------------------------------------

def test_one_process_exchanges_are_the_transpose_sum_and_max(runs):
    """R = 1: the transpose, sum and max, and no collective at all."""
    ref = runs["ref"]
    for i, (cap, x) in enumerate(_buffers()):
        want = x.reshape((W, W, cap) + x.shape[2:]).swapaxes(0, 1) \
            .reshape(x.shape)
        np.testing.assert_array_equal(ref[f"w/a2a/{i}"], want)
        np.testing.assert_array_equal(ref[f"psum/{i}"],
                                      x.sum(0, dtype=np.int64))
        np.testing.assert_array_equal(ref[f"pmax/{i}"], x.max(0))
    assert ref["r/bytes/exchanges"].tolist() == [0, 0, 0]
    assert int(ref["r/bytes/service"]) == 0


def test_one_process_exchanges_are_timed_like_ranked_ones():
    """With ``TIMING`` on, one process times its transposes and
    reductions as a ranked run times its collectives; no byte counts."""
    from repro_torch.core import exchange
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(W, "cpu")
    cap, x = _buffers()[0]
    xt = torch.from_numpy(x)
    kinds = ("all_to_all", "psum", "pmax")
    exchange.reset_counters()
    for fn in (exchange.all_to_all, exchange.psum, exchange.pmax):
        fn(xt, mesh)
    assert [exchange.EXCHANGE_SECONDS[k] for k in kinds] == [0.0] * 3
    exchange.TIMING[0] = True
    try:
        got = [fn(xt, mesh) for fn in (exchange.all_to_all, exchange.psum,
                                       exchange.pmax)]
    finally:
        exchange.TIMING[0] = False
    assert all(exchange.EXCHANGE_SECONDS[k] > 0 for k in kinds)
    assert [exchange.EXCHANGE_BYTES[k] for k in kinds] == [0, 0, 0]
    np.testing.assert_array_equal(got[1].numpy(), x.sum(0, dtype=np.int64))
    np.testing.assert_array_equal(got[2].numpy(), x.max(0))


def test_sharded_store_holds_the_one_process_mesh_by_default():
    from repro_torch.core.delta import RegionStore
    from repro_torch.launch.mesh import WorkerMesh, make_host_mesh
    edges, _ = _stream()
    assert RegionStore(edges, shard_w=W, device="cpu").mesh == \
        make_host_mesh(W, "cpu")
    assert RegionStore(edges, device="cpu").mesh is None
    with pytest.raises(ValueError, match="shards on a mesh"):
        RegionStore(edges, shard_w=W, device="cpu",
                    mesh=WorkerMesh(2 * W, "cpu", 2, 0, "gloo"))


@pytest.mark.parametrize("R", [2, 4])
def test_exchanges_match_one_process(runs, R):
    _each_rank(runs, R, "a2a/")
    _each_rank(runs, R, "psum/")
    _each_rank(runs, R, "pmax/")
    _each_rank(runs, R, "service/")


@pytest.mark.parametrize("R", [2, 4])
def test_exchange_bytes_are_the_analytic_count(runs, R):
    """An all_to_all hands the other ranks (R-1)/R of its buffer; a
    reduction its reduced tensor once for each other rank."""
    wl = W // R
    a2a = psum_b = pmax_b = 0
    for _, x in _buffers():
        a2a += x[:wl].nbytes * (R - 1) // R
        psum_b += x[0].astype(np.int64).nbytes * (R - 1)
        pmax_b += x[0].nbytes * (R - 1)
    for got in runs[R]:
        assert got["r/bytes/exchanges"].tolist() == [a2a, psum_b, pmax_b]


@pytest.mark.parametrize("R", [1, 2, 4])
def test_step_bytes_are_the_dry_run_s_model(runs, R):
    """Each step of the plain one-level joins (a route of 64 and of 8
    slots) hands the other ranks exactly the bytes the dry run's model
    (``distributed.step_exchange_bytes``) counts from the buffers'
    capacities, on every rank; none in one process."""
    for got in ([runs["ref"]] if R == 1 else runs[R]):
        for name in ("triangle", "triangle-defer"):
            steps = got[f"r/step_bytes/{name}"]
            model = int(got[f"r/step_model/{name}"])
            assert steps.size > 2 and set(steps.tolist()) == {model}
            assert (model > 0) == (R > 1)


@pytest.mark.parametrize("R", [2, 4])
def test_service_bytes_are_the_analytic_count(runs, R):
    """One service call sends, through all_to_alls, each request's words
    (an int64 key, an int32 value), the int32 sent mask and the int32
    reply: wl·(w - wl)·cap·(8 + 4 + 4 + 4) bytes a rank, which at w = 4
    over R = 2 is w·cap·words·itemsize."""
    wl, cap = W // R, 8
    for got in runs[R]:
        assert int(got["r/bytes/service"]) == wl * (W - wl) * cap * 20
    if R == 2:
        assert wl * (W - wl) == W


# ---------------------------------------------------------------------------
# the static join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("name", list(STATIC))
def test_static_join_matches_one_process(runs, R, name):
    """Count, counters, worker rows, tuples and weights in worker order:
    the same on every rank, bit for bit the one-process mesh's."""
    ref = runs["ref"]
    for got in runs[R]:
        for part in ("scalars", "tuples", "weights", "worker_rows"):
            np.testing.assert_array_equal(got[f"{name}/{part}"],
                                          ref[f"{name}/{part}"])
    if name == "triangle-defer":
        steps = ref[f"{name}/scalars"][3]
        assert steps > ref["triangle/scalars"][3]  # the deferral retried


@pytest.mark.parametrize("R", [2, 4])
def test_rank_index_shards_are_the_one_process_rows(runs, R):
    for name in STATIC:
        _each_rank(runs, R, f"{name}/index/")


# ---------------------------------------------------------------------------
# the stream: DistDeltaBigJoin and the mesh session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [2, 4])
def test_engine_stream_matches_one_process(runs, R):
    """Every epoch's signed delta, and after every epoch each rank's store
    regions: its workers' rows of the one-process store."""
    ref = runs["ref"]
    assert int(ref[f"engine/{STREAM_EPOCHS - 1}/store/stats/"
                   "compactions"]) > 0  # the stream went through one
    for step in range(STREAM_EPOCHS):
        _each_rank(runs, R, f"engine/{step}/")


def test_engine_deltas_are_exact(runs):
    """Each epoch's delta is the oracle's recount over the live edges
    before and after it."""
    from repro_torch.core import query as Q
    from repro_torch.core.delta import canon_signed, delta_oracle
    live, _ = _stream()
    for step in range(STREAM_EPOCHS):
        got = runs[2][0]
        new = got[f"engine/{step}/edges"]
        ot, ow = delta_oracle(Q.triangle(), live, new)
        assert canon_signed(got[f"engine/{step}/tuples"],
                            got[f"engine/{step}/weights"]) == \
            canon_signed(ot, ow), step
        live = new


def test_mesh_session_matches_one_process(runs):
    """The session with a ``dist.program`` fault at the same hit on every
    rank: the faulted update rolls back on each, and every epoch, the
    count and the enumeration equal the one-process session's."""
    ref = runs["ref"]
    assert [k for k in ref if k.endswith("/faulted")] == ["session/0/faulted"]
    for step in range(STREAM_EPOCHS):
        _each_rank(runs, 2, f"session/{step}/")
    for got in runs[2]:
        for k in ("session/count", "session/enum/tuples",
                  "session/enum/weights", "session/epoch"):
            np.testing.assert_array_equal(got[k], ref[k])


# ---------------------------------------------------------------------------
# against the JAX package's 4-device mesh
# ---------------------------------------------------------------------------

def test_ranked_static_join_matches_jax(runs):
    jax = runs["jax"]
    for R in (2, 4):
        for got in runs[R]:
            for part in ("scalars", "tuples", "weights"):
                np.testing.assert_array_equal(got[f"triangle/{part}"],
                                              jax[f"static/{part}"])


def test_ranked_stream_matches_jax(runs):
    jax = runs["jax"]
    live, stream = _stream()
    for step in range(JAX_EPOCHS):
        upd, w = stream.batch_at(step, live=live)
        np.testing.assert_array_equal(upd, jax[f"{step}/upd"])
        np.testing.assert_array_equal(w, jax[f"{step}/w"])
        for got in runs[2]:
            for part in ("tuples", "weights", "stats"):
                np.testing.assert_array_equal(
                    got[f"engine/{step}/{part}"], jax[f"{step}/{part}"])
        live = runs[2][0][f"engine/{step}/edges"]


def test_gathered_snapshot_matches_jax(runs):
    """The engine's store after the JAX stream's epochs, gathered to rank
    0 at R = 2 and 4 (and in one process): the JAX 4-device mesh's
    ``store.snapshot()``, leaf for leaf and meta for meta."""
    jax = runs["jax"]
    want = json.loads(str(jax["snap/meta"]))
    for got in (runs[2][0], runs[4][0], runs["ref"]):
        assert json.loads(str(got["r/snap/meta"])) == want
        for name in want["names"]:
            a, b = got[f"r/snap/{name}"], jax[f"snap/{name}"]
            assert (a.dtype, a.shape) == (b.dtype, b.shape), name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert not any(k.startswith("r/snap/") for k in runs[2][1])


def test_jax_snapshot_restores_at_two_ranks(runs):
    """The JAX snapshot restored over R = 2 ranks: each rank holds its
    workers' span of the one-process store at that epoch, and the next
    epoch's delta is the uninterrupted engine's."""
    from repro_torch.launch.mesh import WorkerMesh
    ref = runs["ref"]
    src = f"engine/{JAX_EPOCHS - 1}/store/"
    want = {k.replace(src, "restored/"): v for k, v in ref.items()
            if k.startswith(src) or k.startswith("w/" + src)}
    for rank, got in enumerate(runs["from-jax"]):
        lo, hi = WorkerMesh(W, "cpu", 2, rank, "gloo").span
        assert _held(got, want, lo, hi, "restored/") > 10
        for part in ("tuples", "weights", "stats"):
            np.testing.assert_array_equal(
                got[f"next/{part}"], ref[f"engine/{JAX_EPOCHS}/{part}"])


# ---------------------------------------------------------------------------
# failures end fast
# ---------------------------------------------------------------------------

def test_crashed_rank_fails_its_job_fast(runs):
    """Rank 1 raises before a collective that rank 0 waits in: the job
    fails at once, well inside the process-group timeout."""
    job = runs["jobs"][("crash", 2)]
    assert job.codes[1] == 1
    assert job.codes != [0, 0]
    assert job.seconds < PG_TIMEOUT_S


def test_deadlocked_rank_fails_within_the_group_timeout(runs):
    """Rank 1 never joins the collective rank 0 waits in: rank 0's
    collective raises at the group's timeout, and its exit ends the
    job."""
    job = runs["jobs"][("stall", 2)]
    assert job.codes[0] == 1  # rank 0 raised by itself: the timeout
    assert job.codes[1] is not None and job.codes[1] < 0  # then killed
    assert job.seconds < STALL_TIMEOUT_S + 40


# ---------------------------------------------------------------------------
# the CLI harnesses
# ---------------------------------------------------------------------------

def _one_line(runs, name):
    rc, so, se = runs[name]
    assert rc == 0, se[-4000:]
    lines = [ln for ln in so.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, so  # rank 0 prints, and only it
    return json.loads(lines[0])


def test_dist_check_under_torchrun(runs):
    import hashlib
    rec = _one_line(runs, "dist-check")
    ref = runs["ref"]
    digest = hashlib.sha256(
        np.ascontiguousarray(ref["triangle/tuples"]).tobytes()
        + np.ascontiguousarray(ref["triangle/weights"]).tobytes())
    assert (rec["ranks"], rec["backend"], rec["workers"]) == (2, "gloo", 4)
    assert rec["tuples_exact"] and rec["dist_count"] == rec["oracle_count"]
    assert rec["tuples_sha"] == digest.hexdigest()[:16]
    assert [rec["dist_count"], rec["proposals"], rec["intersections"],
            rec["steps"], rec["max_load"], rec["mean_load"]] == \
        ref["triangle/scalars"].tolist()
    assert rec["worker_rows"] == ref["triangle/worker_rows"].tolist()
    assert len(rec["exchange_bytes_per_step"]) == 2
    assert all(b > 0 for b in rec["exchange_bytes_per_step"])
    assert len(rec["index_bytes"]) == 2


def test_dist_check_joins_an_rmat_graph_in_one_process(runs):
    """An R-MAT graph in one process: the oracle's count and tuples, the
    one process's exchanges timed though none crosses a rank, and without
    the oracle the same line less its verdict."""
    rec = _one_line(runs, "dist-rmat")
    assert (rec["ranks"], rec["backend"]) == (1, None)
    assert rec["dist_count"] == rec["oracle_count"] > 0
    assert rec["tuples_exact"]
    assert rec["exchange_bytes_per_step"] == [0.0]
    assert rec["exchange_ms_per_step"][0] > 0
    bare = _one_line(runs, "dist-rmat-unchecked")
    assert bare["oracle_count"] is None and bare["tuples_exact"] is None
    for k in ("dist_count", "steps", "proposals", "worker_rows",
              "tuples_sha", "edges", "index_bytes"):
        assert bare[k] == rec[k], k


def test_delta_dist_check_under_torchrun(runs):
    rec = _one_line(runs, "delta-check")
    assert (rec["ranks"], rec["backend"]) == (2, "gloo")
    assert rec["all_exact"] and len(rec["epochs"]) == 3
    assert all(ep["exact"] for ep in rec["epochs"])
    assert len(rec["store_bytes"]) == 2 and min(rec["store_bytes"]) > 0


def test_nccl_without_cards_is_refused(runs):
    """``--backend nccl`` on a machine without the cards raises; it never
    runs on gloo instead."""
    rc, so, se = runs["nccl-refused"]
    assert rc != 0 and not so.strip()
    assert "NCCL puts one rank on a card" in se
    from repro_torch.launch.mesh import init_rank_mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="one rank on a card"):
            init_rank_mesh(W, "nccl", rank=0, ranks=1)
    with pytest.raises(ValueError, match="NCCL runs on the cards"):
        init_rank_mesh(W, "nccl", "cpu", rank=0, ranks=1)


# ---------------------------------------------------------------------------
# the rank mesh itself
# ---------------------------------------------------------------------------

def test_worker_mesh_ranks():
    from repro_torch.launch.mesh import WorkerMesh, make_host_mesh
    m = WorkerMesh(8, "cpu", 4, 3, "gloo")
    assert (m.local_workers, m.span) == (2, (6, 8))
    assert hash(m) == hash(WorkerMesh(8, "cpu", 4, 3, "gloo"))
    assert m != WorkerMesh(8, "cpu", 4, 2, "gloo")
    assert make_host_mesh(4, "cpu") == WorkerMesh(4, "cpu", 1, 0, None)
    with pytest.raises(ValueError, match="split evenly"):
        WorkerMesh(6, "cpu", 4, 0, "gloo")
    with pytest.raises(ValueError, match="backend"):
        WorkerMesh(4, "cpu", 2, 0)
    with pytest.raises(ValueError):
        WorkerMesh(4, "cpu", 2, 2, "gloo")


def test_init_rank_mesh_checks_its_arguments(monkeypatch):
    from repro_torch.launch.mesh import init_rank_mesh
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        init_rank_mesh(4, "gloo", "cpu")
    with pytest.raises(ValueError, match="backend"):
        init_rank_mesh(4, "mpi", "cpu", rank=0, ranks=1)
    with pytest.raises(ValueError, match="split evenly"):
        init_rank_mesh(6, "gloo", "cpu", rank=0, ranks=4)
