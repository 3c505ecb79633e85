"""Multi-relation differential harness of the port (§5.4 on a mesh):

    python -m repro_torch.core._nary_dist_check --workers 4 --batches 20 \
        [--device cpu]

One mesh :class:`repro_torch.api.GraphSession` of ``--workers`` workers
(a leading tensor axis on ``--device``, default the card) owns TWO
dynamic relations — the binary ``edge`` stream and the materialised
ternary ``tri`` relation — and serves triangle (the tri feeder), 4-clique
(the edge-only reference) and 4-clique-tri (the §5.4 ternary plan).
Every logical epoch applies one mixed insert/delete edge batch, then the
signed triangle delta to ``tri``; the 4-clique-tri output delta must
equal the edge-only 4-clique delta BIT FOR BIT (signed tuple sets, not
counts).  Prints one JSON line: per-epoch wall times, exactness, the
shards' live entries; exits 0 only when every epoch is exact.

With ``--backend gloo|nccl`` it is one rank of a mesh of R processes
(under ``python -m torch.distributed.run --nproc-per-node R``): rank 0
prints the line, and every rank exits non-zero on a mismatch.
"""
import sys

if __name__ == "__main__":
    import argparse

    from repro_torch.launch.mesh import BACKENDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--nv", type=int, default=24)
    ap.add_argument("--ne", type=int, default=160)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=256,
                    help="B' proposal budget per worker per step")
    ap.add_argument("--local", action="store_true",
                    help="the one-device session instead of the mesh")
    ap.add_argument("--device", default=None,
                    help="device of the workers (default: the card; cpu: "
                    "the plain versions)")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="run as one rank of a mesh over torch.distributed "
                    "(under python -m torch.distributed.run)")
    args = ap.parse_args()
    if args.backend and args.local:
        ap.error("--local is one process: it takes no --backend")

    import json
    import time

    import numpy as np

    from repro_torch.api import (GraphSession, canon_signed as canon,
                                 oracle_count)
    from repro_torch.core.exchange import per_rank
    from repro_torch.data.synthetic import EdgeUpdateStream, uniform_graph
    from repro_torch.launch.mesh import (close_rank_mesh, init_rank_mesh,
                                         make_host_mesh)

    e = uniform_graph(args.nv, args.ne, args.seed)
    mesh = None
    if args.backend:
        mesh = init_rank_mesh(args.workers, args.backend, args.device)
    elif not args.local:
        mesh = make_host_mesh(args.workers, args.device)
    session = GraphSession(
        e, device=args.device, mesh=mesh,
        batch=args.batch, out_capacity=1 << 18,
        update_batch=args.batch_size)
    # the local session's one process, for the per-rank readings below
    mesh = session.mesh or make_host_mesh(1, session.device)
    tri = session.register("triangle")
    c4 = session.register("4-clique")
    tri0, _ = tri.enumerate()
    session.add_relation("tri", tri0)
    c4t = session.register("4-clique-tri")
    static_exact = c4t.count() == c4.count() == oracle_count("4-clique", e)

    stream = EdgeUpdateStream(args.nv, args.batch_size, seed=args.seed + 1)
    epochs = []
    all_exact = bool(static_exact)
    live = session.edges
    for step in range(args.batches):
        upd, w = stream.batch_at(step, live=live)
        t0 = time.time()
        r1 = session.update(upd, w)
        td = r1.deltas["triangle"]
        t_upd = td.tuples if td.tuples is not None else \
            np.zeros((0, 3), np.int32)
        t_w = td.weights if td.weights is not None else \
            np.zeros(0, np.int32)
        r2 = session.update({"tri": (t_upd, t_w)})
        dt = time.time() - t0
        live = r1.advance(live)
        a, b = r1.deltas["4-clique"], r2.deltas["4-clique-tri"]
        exact = canon(b.tuples, b.weights) == canon(a.tuples, a.weights)
        all_exact = all_exact and exact
        epochs.append({
            "epoch": step, "updates": int(upd.shape[0]),
            "edge_delta": int(a.count_delta),
            "tri_rel_delta": int(td.count_delta),
            "exact": bool(exact), "elapsed_s": round(dt, 4)})

    # maintained totals survive full recomputation on BOTH plans
    net_exact = (c4.net_change == c4t.net_change ==
                 oracle_count("4-clique", session.edges)
                 - oracle_count("4-clique", e))
    all_exact = all_exact and bool(net_exact)
    shard_entries = sum(per_rank(sum(
        reg.versioned("new").live_entries()
        for reg in session.store.projections.values() if not reg.derived),
        mesh))
    out = {
        "workers": args.workers, "device": str(session.device),
        "mode": "local" if args.local else "dist",
        "edges_start": int(e.shape[0]),
        "edges_end": int(session.num_edges),
        "tri_end": int(session.num_tuples("tri")),
        "batches": args.batches, "batch_size": args.batch_size,
        "static_exact": bool(static_exact), "net_exact": bool(net_exact),
        "all_exact": bool(all_exact),
        "shard_entries": int(shard_entries),
        "warm_epochs_per_s": round(
            len(epochs[2:]) / max(sum(r["elapsed_s"] for r in epochs[2:]),
                                  1e-9), 2) if len(epochs) > 2 else None,
        "epochs": epochs,
    }
    if mesh.rank == 0:
        print(json.dumps(out))
    close_rank_mesh()
    sys.exit(0 if all_exact else 1)
