"""Concurrent-serving differential harness (DESIGN.md §9), the JAX
package's ``repro.serve._serve_check`` on one device:

    # Mode A: N tenants through one SessionPool vs prewarmed isolated
    # oracle sessions — per-epoch deltas bit-exact, serving compiles 0
    python -m repro_torch.serve._serve_check --tenants 4 --epochs 20

    # Mode B: kill/resume failover — an uninterrupted oracle RUN, a victim
    # run killed mid-stream (os._exit right after a WAL append), and a
    # resume run that recovers snapshot+WAL and finishes the stream; the
    # parent diffs per-epoch delta digests and final state digests
    python -m repro_torch.serve._serve_check --supervise --tenants 4 \
        --epochs 20 --kill-at 13

    # Mode C: chaos — a seeded random fault schedule (repro_torch.faults)
    # armed across every fault point that has a caller while N tenants
    # serve; failed epochs roll back atomically, overflows escalate+replay
    # transparently, and the final per-tenant state must be BIT-EXACT with
    # a fault-free in-process oracle that applied exactly the batches that
    # succeeded.  Failed batches are excluded AND accounted (submitted ==
    # retired + failed); serving compiles must be 0.
    python -m repro_torch.serve._serve_check --chaos --tenants 4 \
        --epochs 30 --tight-out 32

Everything runs on ``--device`` (default the card; the tests pass
``cpu``).  ``--workers N`` above 1 builds every session and the pool on
a mesh of N workers (every region hash-sharded over them); its chaos
schedule then spans all eight fault points, ``dist.program`` (fired by
each mesh program run) included.  One worker keeps the one-device
sessions, where nothing fires ``dist.program``.

``--backend gloo|nccl`` spreads the pool's mesh over the ranks of
``python -m torch.distributed.run`` (``launch.mesh.init_rank_mesh``):
rank 0 submits and checks, every rank serves, and rank 0 prints the
line.  The isolated oracles stay one-process sessions (on the same
number of workers) on rank 0.  Mode B with ``--backend`` is a plain
process whose three runs are jobs of ``--ranks`` ranks under
``torch.distributed.run``; the victim job ends when rank 0 exits right
after its WAL append::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.serve._serve_check --backend gloo --workers 4
    python -m repro_torch.serve._serve_check --supervise --backend gloo \
        --ranks 2 --workers 4

Every tenant gets its OWN initial graph and update stream (derived from
``--seed`` + tenant index, so a resume child regenerates them exactly);
batches are drawn with ``insert_frac=0.5`` so the live set stays near its
initial size.  Prints one JSON line; exit code 0 iff every check held.
"""
import os
import sys

# the points a one-device run fires: every point but dist.program, which
# fires where a mesh program runs (a run of more than one worker spans
# them all, faults.POINTS)
CHAOS_POINTS = ("store.commit.fold", "store.normalize", "pool.prep",
                "pool.apply", "wal.append", "wal.fsync", "snapshot.write")


def _mesh(args):
    """The pool's mesh: ``--workers`` workers on ``--device``, over the
    ranks of ``--backend`` when given (joined once, kept on ``args``), or
    None for the one-device sessions (one worker)."""
    if args.workers <= 1:
        return None
    if args.backend:
        if getattr(args, "rank_mesh", None) is None:
            from repro_torch.launch.mesh import init_rank_mesh
            args.rank_mesh = init_rank_mesh(args.workers, args.backend,
                                            args.device)
        return args.rank_mesh
    return _oracle_mesh(args)


def _oracle_mesh(args):
    """The isolated oracles' mesh: one process's, as many workers."""
    if args.workers <= 1:
        return None
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(args.workers, args.device)


def _is_root(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def _leave(mesh) -> None:
    if mesh is not None and mesh.ranks > 1:
        from repro_torch.launch.mesh import close_rank_mesh
        close_rank_mesh()


def _graphs(args, names):
    """Each tenant's initial graph (uniform, or R-MAT of ``--rmat-scale``,
    edge factor 16) and the vertex count of the streams."""
    from repro_torch.data.synthetic import rmat_graph, uniform_graph
    if args.rmat_scale:
        return {n: rmat_graph(args.rmat_scale, 16, seed=args.seed + i)
                for i, n in enumerate(names)}, 1 << args.rmat_scale
    return {n: uniform_graph(args.nv, args.ne, args.seed + i)
            for i, n in enumerate(names)}, args.nv


def _leaves_digest(snap):
    """A digest of a snapshot's leaves, named (rank 0's; None on the other
    ranks of a mesh).  Its meta stays out: a recovered session builds its
    engines at the restored live count, so its ``("sizing",)`` ratchet
    mark may sit a rung above the uninterrupted run's while every region
    is the same."""
    if snap is None:
        return None
    import hashlib
    import numpy as np
    h = hashlib.sha1()
    for name, leaf in zip(snap[1]["names"], snap[0]):
        h.update(name.encode())
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()[:16]


def _timing(handles, mesh):
    """Each tenant's apply ms (p50) and the durability's last snapshot
    gather, restore and replay seconds on rank 0, and a list a rank of
    the snapshot rows sent to rank 0, the restore spans sent from it and
    the device bytes of every tenant's store (a collective on a mesh)."""
    import numpy as np
    from repro_torch.core import exchange

    def rank_list(v):
        return exchange.per_rank(int(v), mesh) if mesh is not None \
            else [int(v)]
    out = {"apply_ms_p50": {}, "snapshot_s": {}, "restore_s": {},
           "replay_s": {}}
    for n, h in handles.items():
        ms = h.stats.apply_ms
        out["apply_ms_p50"][n] = float(np.percentile(ms, 50)) if ms \
            else None
        d = h.durability
        if d is not None:
            out["snapshot_s"][n] = d.snapshot_s
            out["restore_s"][n] = d.restore_s
            out["replay_s"][n] = d.replay_s
    out["snapshot_bytes"] = rank_list(exchange.EXCHANGE_BYTES["gather_root"])
    out["restore_bytes"] = rank_list(
        exchange.EXCHANGE_BYTES["scatter_root"])
    out["device_bytes"] = rank_list(sum(
        h.session.store.device_bytes() for h in handles.values()))
    return out


def _digest(obj) -> str:
    import hashlib
    return hashlib.sha1(repr(obj).encode()).hexdigest()[:16]


def worker(args) -> int:
    """One serving run (Mode A, or one leg of Mode B).  Drives every
    tenant synchronously — submit one batch per tenant per step, wait for
    all tickets — so per-epoch deltas are attributable and streams can be
    re-derived from the live set after recovery.  On a mesh of ranks the
    other ranks serve rank 0's records meanwhile (``pool.drain``)."""
    import json
    import time

    import numpy as np

    from repro_torch.api import GraphSession, canon_signed as canon
    from repro_torch.data.synthetic import EdgeUpdateStream
    from repro_torch.serve import SessionPool

    t_start = time.time()
    mesh = _mesh(args)
    root = _is_root(mesh)

    def note(msg):
        # stage timings on stderr: logs show where a slow run spends its
        # wall clock
        if root:
            sys.stderr.write(f"[serve_check +{time.time() - t_start:7.1f}s]"
                             f" {msg}\n")
            sys.stderr.flush()

    from repro_torch.core import exchange
    names = [f"t{i}" for i in range(args.tenants)]
    graphs, nv = _graphs(args, names)
    streams = {n: EdgeUpdateStream(nv, args.batch_size,
                                   insert_frac=0.5, seed=args.seed + 100 + i)
               for i, n in enumerate(names)}
    exchange.reset_counters()

    # In-process oracles FIRST (Mode A only): prewarming them here keeps
    # their kernel-library loads out of the pool's serving compile budget.
    oracles = {}
    if args.oracle and root:
        for n in names:
            o = GraphSession(graphs[n], device=args.device,
                             mesh=_oracle_mesh(args),
                             update_batch=args.update_batch)
            o.register(args.query)
            spent = o.prewarm(horizon=args.update_batch * (args.epochs + 2))
            note(f"oracle {n}: {len(graphs[n])} edges, "
                 f"prewarm {spent} compiles")
            oracles[n] = o

    kill_box = {}

    def on_logged(name, epoch):
        # fires right AFTER the WAL append, BEFORE the device apply: the
        # harshest crash point — the record must replay as the apply
        if args.kill_at and name == args.kill_tenant and \
                epoch == args.kill_at:
            sys.stdout.flush()
            os._exit(9)
        kill_box[name] = epoch

    pool = SessionPool(
        device=args.device, mesh=mesh,
        update_batch=args.update_batch,
        pipeline=not args.pump, durable_dir=args.durable_dir,
        snapshot_every=args.snapshot_every, fsync=not args.no_fsync,
        on_logged=on_logged if args.durable_dir else None,
        horizon=args.update_batch * (args.epochs + 2))
    handles, starts, lives = {}, {}, {}
    for n in names:
        handles[n] = pool.admit(n, graphs[n], queries=(args.query,),
                                coalesce=1, update_batch=args.update_batch)
        starts[n] = handles[n].session.epoch  # >0 after recovery
        lives[n] = np.asarray(handles[n].session.edges)
        note(f"admitted {n}: start epoch {starts[n]}, "
             f"prewarm {handles[n].stats.prewarm_compiles} compiles, "
             f"replayed {handles[n].stats.replayed}")

    digests = {n: {} for n in names}
    exact = True
    t0 = time.time()
    for step in range(args.epochs if root else 0):
        tickets = {}
        for n in names:
            if step < starts[n]:
                continue  # this tenant's recovery already covered it
            upd, w = streams[n].batch_at(step, live=lives[n])
            tickets[n] = (handles[n].submit(upd, w), upd, w)
        if args.pump:
            pool.pump()
        served = {}
        for n, (ticket, upd, w) in tickets.items():
            res = ticket.result(timeout=600)
            lives[n] = res.advance(lives[n])
            d = res.deltas[args.query]
            served[n] = canon(d.tuples, d.weights)
            digests[n][str(res.epoch)] = _digest(served[n])
        # every ticket above has resolved, so the pool's apply thread is
        # idle — only NOW does this thread launch the oracles' kernels, so
        # one thread launches at a time (the launch counters are unlocked;
        # see the pool's docstring).
        for n, (_ticket, upd, w) in tickets.items():
            if n in oracles:
                ores = oracles[n].update(upd, w)
                od = ores.deltas[args.query]
                exact = exact and (
                    served[n] == canon(od.tuples, od.weights))
    if not root and args.pump:
        for _ in range(args.epochs):
            pool.pump()  # rank 0's pump of each step
    pool.drain()
    note(f"served {args.epochs} steps x {args.tenants} tenants")
    stats = pool.stats()
    timing = _timing(handles, mesh)  # before the final snapshots below
    final = {}
    for n in names:
        s = handles[n].session
        final[n] = {
            "epoch": int(s.epoch),
            "num_edges": int(s.num_edges),
            "edges": _digest(np.asarray(s.edges).tobytes()),
            "net_change": int(s[args.query].net_change),
            # every leaf of the store, gathered to rank 0
            "leaves": _leaves_digest(s.snapshot())}
        if n in oracles:
            o = oracles[n]
            exact = exact and (
                final[n]["edges"] == _digest(np.asarray(o.edges).tobytes())
                and final[n]["net_change"]
                == int(o[args.query].net_change))
    pool.close()
    agg = stats.aggregate()
    out = {
        "mode": "worker", "device": str(pool.device),
        "workers": args.workers, "local": args.workers <= 1,
        "ranks": 1 if mesh is None else mesh.ranks,
        "backend": None if mesh is None else mesh.backend,
        "tenants": args.tenants, "epochs": args.epochs,
        "starts": {n: int(s) for n, s in starts.items()},
        "oracle_exact": bool(exact) if args.oracle else None,
        "prewarm_compiles": agg["prewarm_compiles"],
        "serve_compiles": agg["serve_compiles"],
        "snapshots": agg["snapshots"],
        "replayed": agg["replayed"],
        "elapsed_s": round(time.time() - t0, 2),
        "digests": digests,
        "final": final,
        "timing": timing,
    }
    _leave(mesh)
    if not root:
        return 0
    print(json.dumps(out))
    ok = (exact if args.oracle else True) and agg["serve_compiles"] == 0
    return 0 if ok else 1


def chaos(args) -> int:
    """Mode C: deterministic chaos run (module docstring).

    Pump mode on purpose: prep+apply run inline on THIS thread, so the
    fault registry's hit counters advance in one deterministic order and
    a (seed, rate) pair — or a pinned ``--faults`` spec — reproduces the
    exact same injection sequence every run.  The fault-free oracles run
    in the same process under ``faults.disabled()`` and apply ONLY the
    batches whose tickets resolved, so any torn commit (a rollback that
    left partial state) or lost/duplicated batch shows up as a digest
    mismatch.  On a mesh of ranks every rank installs the same schedule
    and pumps once a step; the oracles and the checks are rank 0's."""
    import json
    import shutil
    import tempfile
    import time

    import numpy as np

    from repro_torch import faults
    from repro_torch.api import GraphSession, canon_signed as canon
    from repro_torch.data.synthetic import EdgeUpdateStream
    from repro_torch.serve import SessionPool

    t_start = time.time()
    mesh = _mesh(args)
    root = _is_root(mesh)

    def note(msg):
        if root:
            sys.stderr.write(f"[chaos +{time.time() - t_start:7.1f}s] "
                             f"{msg}\n")
            sys.stderr.flush()

    names = [f"t{i}" for i in range(args.tenants)]
    graphs, nv = _graphs(args, names)
    streams = {n: EdgeUpdateStream(nv, args.batch_size,
                                   insert_frac=0.5, seed=args.seed + 100 + i)
               for i, n in enumerate(names)}

    oracles = {}
    for n in names if root else ():
        o = GraphSession(graphs[n], device=args.device,
                         mesh=_oracle_mesh(args),
                         update_batch=args.update_batch)
        o.register(args.query)
        o.prewarm(horizon=args.update_batch * (args.epochs + 2))
        oracles[n] = o
    note(f"{len(oracles)} fault-free oracles prewarmed")

    # rank 0 owns the durable directory: the others never touch it
    made = not args.durable_dir and root
    tmp = args.durable_dir or (tempfile.mkdtemp(prefix="serve_chaos_")
                               if root else "rank-0-only")
    pool = SessionPool(
        device=args.device, mesh=mesh,
        update_batch=args.update_batch,
        pipeline=False, durable_dir=tmp,
        snapshot_every=args.snapshot_every, fsync=not args.no_fsync,
        horizon=args.update_batch * (args.epochs + 2))
    handles, lives = {}, {}
    for n in names:
        # --tight-out admits tenants with a deliberately small output
        # rung so real overflows occur and must escalate+replay — the
        # oracles keep default sizing, so exactness also proves the
        # escalated replay path
        handles[n] = pool.admit(
            n, graphs[n], queries=(args.query,), coalesce=1,
            out_capacity=args.tight_out or None,
            update_batch=args.update_batch)
        lives[n] = np.asarray(handles[n].session.edges)
    note(f"admitted {args.tenants} tenants"
         + (f" (tight out rung {args.tight_out})" if args.tight_out else ""))

    if args.faults:
        schedule = faults.parse_spec(args.faults)
        note(f"pinned fault schedule: {args.faults}")
    else:
        schedule = faults.random_schedule(
            args.seed + 777,
            points=faults.POINTS if args.workers > 1 else CHAOS_POINTS,
            horizon=args.chaos_horizon, rate=args.chaos_rate)
        note(f"random fault schedule: seed {args.seed + 777} "
             f"rate {args.chaos_rate} over {sorted(schedule)}")
    faults.install(schedule)

    counts = {n: {"submitted": 0, "ok": 0, "failed": 0, "refused": 0}
              for n in names}
    digests = {n: {} for n in names}
    exact = True
    t0 = time.time()
    try:
        for step in range(args.epochs):
            if not root:
                pool.pump()  # rank 0's records of this step
                continue
            tickets = {}
            for n in names:
                upd, w = streams[n].batch_at(step, live=lives[n])
                try:
                    tk = handles[n].submit(upd, w)
                except RuntimeError:  # quarantined: fence holds
                    counts[n]["refused"] += 1
                    continue
                counts[n]["submitted"] += 1
                tickets[n] = (tk, upd, w)
            pool.pump()
            applied = {}
            for n, (tk, upd, w) in tickets.items():
                try:
                    res = tk.result(timeout=600)
                except Exception as e:
                    # failed epoch: rolled back, WAL record aborted —
                    # state must be EXACTLY as if never submitted
                    counts[n]["failed"] += 1
                    note(f"step {step} {n}: failed "
                         f"({type(e).__name__}: {e})")
                    continue
                counts[n]["ok"] += 1
                lives[n] = res.advance(lives[n])
                d = res.deltas[args.query]
                applied[n] = (upd, w, canon(d.tuples, d.weights))
                digests[n][str(res.epoch)] = _digest(applied[n][2])
            # oracles apply ONLY the surviving batches, fault-free, on
            # this same thread (pump mode: the pool launches here too)
            with faults.disabled():
                for n, (upd, w, served) in applied.items():
                    ores = oracles[n].update(upd, w)
                    od = ores.deltas[args.query]
                    exact = exact and served == canon(od.tuples, od.weights)
        pool.drain()
        stats = pool.stats()
        final = {}
        with faults.disabled():
            for n in names:
                s = handles[n].session
                final[n] = {
                    "epoch": int(s.epoch),
                    "num_edges": int(s.num_edges),
                    "edges": _digest(np.asarray(s.edges).tobytes()),
                    "net_change": int(s[args.query].net_change)}
                if n not in oracles:
                    continue
                o = oracles[n]
                exact = exact and (
                    final[n]["edges"]
                    == _digest(np.asarray(o.edges).tobytes())
                    and final[n]["net_change"]
                    == int(o[args.query].net_change))
        injected = faults.injected()
        pool.close()
    finally:
        faults.clear()
        if made:
            shutil.rmtree(tmp, ignore_errors=True)
    _leave(mesh)
    if not root:
        return 0

    agg = stats.aggregate()
    accounted = all(
        c["submitted"] == c["ok"] + c["failed"] for c in counts.values())
    # the port re-prewarms nothing after an escalation, so no serving
    # compile is sanctioned
    compiles_ok = agg["serve_compiles"] == 0
    chaotic = len(injected) > 0  # a chaos run that injected nothing
    #                              tested nothing — fail loudly
    out = {
        "mode": "chaos", "device": str(pool.device),
        "workers": args.workers, "local": args.workers <= 1,
        "ranks": 1 if mesh is None else mesh.ranks,
        "backend": None if mesh is None else mesh.backend,
        "tenants": args.tenants, "epochs": args.epochs,
        "faults_injected": len(injected),
        "injected": [f"{p}@{h}" for p, h in injected[:40]],
        "counts": counts,
        "escalations": agg["escalations"], "replays": agg["replays"],
        "escalation_compiles": agg["escalation_compiles"],
        "serve_compiles": agg["serve_compiles"],
        "failed": agg["failed"],
        "wal_errors": agg["wal_errors"],
        "wal_degraded": agg["wal_degraded"],
        "quarantined": agg["quarantined"],
        "oracle_exact": bool(exact),
        "accounted": bool(accounted),
        "compiles_ok": bool(compiles_ok),
        "elapsed_s": round(time.time() - t0, 2),
        "final": final,
    }
    print(json.dumps(out))
    ok = exact and accounted and compiles_ok and chaotic
    return 0 if ok else 1


def supervise(args) -> int:
    """Mode B parent: oracle run beside a victim run (killed mid-stream),
    then a resume run — then diff digests.  Each run is a child process
    of THIS module, so the victim can die by ``os._exit``; with
    ``--backend`` each run is a job of ``--ranks`` ranks under
    ``torch.distributed.run``, which ends the whole job when rank 0
    exits."""
    import json
    import shutil
    import subprocess
    import tempfile
    import time
    from concurrent.futures import ThreadPoolExecutor

    if args.backend and ("RANK" in os.environ
                         or "WORLD_SIZE" in os.environ):
        raise SystemExit("--supervise starts its own jobs of ranks: run it "
                         "as a plain process, not under "
                         "torch.distributed.run")
    launcher = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", str(args.ranks), "-m",
                "repro_torch.serve._serve_check", "--backend",
                args.backend] if args.backend else \
        [sys.executable, "-m", "repro_torch.serve._serve_check"]

    def run(extra, expect=0):
        # a killed job of ranks exits with torch.distributed.run's code
        # for a failed worker, not the victim's own
        cmd = launcher + [
               "--device", args.device,
               "--tenants", str(args.tenants),
               "--workers", str(args.workers),
               "--epochs", str(args.epochs),
               "--nv", str(args.nv), "--ne", str(args.ne),
               "--rmat-scale", str(args.rmat_scale),
               "--batch-size", str(args.batch_size),
               "--update-batch", str(args.update_batch),
               "--seed", str(args.seed), "--query", args.query,
               "--snapshot-every", str(args.snapshot_every),
               "--no-oracle", "--no-fsync"] + extra
        sys.stderr.write(f"[supervise] child {extra or ['oracle']}...\n")
        sys.stderr.flush()
        t0 = time.time()
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=1800)
        sys.stderr.write(f"[supervise] child {extra or ['oracle']} exited "
                         f"{p.returncode} in {time.time() - t0:.0f}s\n")
        sys.stderr.flush()
        if p.returncode != expect and not (
                args.backend and expect and p.returncode):
            sys.stderr.write(p.stdout + p.stderr)
            raise SystemExit(
                f"child {extra} exited {p.returncode}, wanted {expect}")
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        return json.loads(line[-1]) if line else None

    tmp = tempfile.mkdtemp(prefix="serve_check_")
    try:
        victim_dir = os.path.join(tmp, "victim")
        kill_tenant = f"t{args.tenants // 2}"
        # the oracle (uninterrupted, no durability: ground truth) shares
        # nothing with the victim, so the two run side by side
        with ThreadPoolExecutor(2) as ex:
            oracle_run = ex.submit(run, [])
            victim_run = ex.submit(
                run, ["--durable-dir", victim_dir, "--kill-at",
                      str(args.kill_at), "--kill-tenant", kill_tenant],
                expect=9)
        oracle = oracle_run.result()
        victim_run.result()
        resumed = run(["--durable-dir", victim_dir])

        final_exact = oracle["final"] == resumed["final"]
        # every post-recovery epoch the resume run re-served must produce
        # the oracle's exact signed delta
        tail_exact, compared = True, 0
        for n, per_epoch in resumed["digests"].items():
            for epoch, dg in per_epoch.items():
                compared += 1
                tail_exact = tail_exact and \
                    oracle["digests"][n].get(epoch) == dg
        recovered = any(s > 0 for s in resumed["starts"].values())
        compiles_ok = (oracle["serve_compiles"] == 0
                       and resumed["serve_compiles"] == 0)
        ok = final_exact and tail_exact and recovered and compiles_ok \
            and compared > 0
        print(json.dumps({
            "mode": "supervise", "device": args.device,
            "workers": args.workers, "local": args.workers <= 1,
            "ranks": args.ranks if args.backend else 1,
            "backend": args.backend or None,
            "tenants": args.tenants, "epochs": args.epochs,
            "kill_at": args.kill_at, "kill_tenant": kill_tenant,
            "resume_starts": resumed["starts"],
            "replayed": resumed["replayed"],
            "final_exact": bool(final_exact),
            "tail_exact": bool(tail_exact), "tail_compared": compared,
            "serve_compiles": [oracle["serve_compiles"],
                               resumed["serve_compiles"]],
            "all_exact": bool(ok)}))
        return 0 if ok else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--supervise", action="store_true",
                    help="kill/resume failover differential (Mode B)")
    ap.add_argument("--chaos", action="store_true",
                    help="deterministic fault-injection run (Mode C)")
    ap.add_argument("--chaos-rate", type=float, default=0.05,
                    help="per-hit fault probability for the seeded "
                         "random schedule")
    ap.add_argument("--chaos-horizon", type=int, default=400,
                    help="hits per point covered by the random schedule")
    ap.add_argument("--faults", default="",
                    help="pinned fault spec (repro_torch.faults.parse_spec "
                         "syntax) instead of the seeded random schedule")
    ap.add_argument("--tight-out", type=int, default=0,
                    help="chaos: admit tenants with this small output "
                         "rung to force escalate+replay")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--workers", type=int, default=1,
                    help="mesh workers of every session and the pool (1: "
                    "one device's sessions)")
    ap.add_argument("--device", default="cuda",
                    help="device of every session and pool (cpu: the "
                    "plain versions)")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--nv", type=int, default=24)
    ap.add_argument("--ne", type=int, default=160)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--update-batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rmat-scale", type=int, default=0,
                    help="each tenant's graph an R-MAT graph of this scale "
                    "(edge factor 16) instead of the uniform --nv/--ne "
                    "one")
    ap.add_argument("--query", default="triangle")
    ap.add_argument("--durable-dir", default=None)
    ap.add_argument("--snapshot-every", type=int, default=4)
    ap.add_argument("--no-fsync", action="store_true")
    ap.add_argument("--no-oracle", dest="oracle", action="store_false")
    ap.add_argument("--pump", action="store_true",
                    help="synchronous pump instead of pipeline threads")
    ap.add_argument("--kill-at", type=int, default=0,
                    help="os._exit(9) when --kill-tenant logs this epoch")
    ap.add_argument("--kill-tenant", default="t0")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="serve on a mesh of --workers workers over the "
                    "ranks of torch.distributed.run (--supervise: start "
                    "jobs of --ranks ranks)")
    ap.add_argument("--ranks", type=int, default=2,
                    help="--supervise --backend: ranks of each job")
    args = ap.parse_args(argv)
    if args.backend and args.workers <= 1:
        ap.error("--backend spreads a mesh over ranks: give --workers "
                 "above 1")
    if args.workers < 1:
        raise ValueError(f"--workers must be at least 1, got "
                         f"{args.workers}")
    if args.supervise:
        return supervise(args)
    if args.chaos:
        return chaos(args)
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
