"""Distributed Delta-BiGJoin differential harness of the port:

    python -m repro_torch.core._delta_dist_check --workers 4 \
        --query triangle --batches 20 [--balance] [--skew] [--device cpu]

Per update epoch it applies one mixed insert/delete batch through
``DistDeltaBigJoin`` on ``--workers`` workers (a leading tensor axis on
``--device``, default the card) and checks the SIGNED output tuples bit
for bit against ``delta_oracle`` (full recomputation on the before/after
edge sets).  The graph is uniform (``--nv``/``--ne``) or R-MAT of
``--rmat-scale`` (edge factor 16).  Prints one JSON line: per-epoch wall
times, throughput, exactness, a digest of each epoch's signed tuples and
weights in order (``sha``), and the shards' live entries; exits 0 only
when every epoch is exact.  The mesh's exchanges are timed between two
device synchronisations (``exchange.TIMING``), with one process as with
R.

With ``--backend gloo|nccl`` it is one rank of a mesh of R processes
(under ``python -m torch.distributed.run --nproc-per-node R``): rank 0
prints the line, with each rank's exchange bytes and seconds an epoch,
its device bytes of store and its kernel launches over the epochs;
every rank exits non-zero on a mismatch.
"""
import sys

if __name__ == "__main__":
    import argparse

    from repro_torch.launch.mesh import BACKENDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--query", default="triangle")
    ap.add_argument("--nv", type=int, default=40)
    ap.add_argument("--ne", type=int, default=400)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rmat-scale", type=int, default=None,
                    help="an R-MAT graph of this scale, edge factor 16, "
                    "instead of the uniform --nv/--ne one")
    ap.add_argument("--batch", type=int, default=256,
                    help="B' proposal budget per worker per step")
    ap.add_argument("--balance", action="store_true")
    ap.add_argument("--skew", action="store_true")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the delta_oracle differential (bench mode)")
    ap.add_argument("--local", action="store_true",
                    help="the one-device DeltaBigJoin instead of the mesh "
                    "engine (the streaming baseline)")
    ap.add_argument("--device", default=None,
                    help="device of the workers (default: the card; cpu: "
                    "the plain versions)")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="run as one rank of a mesh over torch.distributed "
                    "(under python -m torch.distributed.run)")
    args = ap.parse_args()
    if args.backend and args.local:
        ap.error("--local is one process: it takes no --backend")

    import hashlib
    import json
    import time

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import exchange
    from repro_torch.core import query as Q
    from repro_torch.core.delta import (DeltaBigJoin, canon_signed as canon,
                                        delta_oracle)
    from repro_torch.core.distributed import (DistDeltaBigJoin,
                                              default_delta_config)
    from repro_torch.data.synthetic import (EdgeUpdateStream, rmat_graph,
                                            uniform_graph)
    from repro_torch.launch.mesh import (close_rank_mesh, init_rank_mesh,
                                         make_host_mesh)

    rng = np.random.default_rng(args.seed)
    nv = args.nv
    if args.rmat_scale is not None:
        nv = 1 << args.rmat_scale
        e = rmat_graph(args.rmat_scale, 16, seed=args.seed)
    elif args.skew:
        u = (rng.zipf(1.4, args.ne) % args.nv).astype(np.int64)
        v = rng.integers(0, args.nv, args.ne)
        keep = u != v
        e = np.unique(np.stack([u[keep], v[keep]], 1).astype(np.int32),
                      axis=0)
    else:
        e = uniform_graph(args.nv, args.ne, args.seed)

    q = Q.query_by_name(args.query)
    if args.local:
        from repro_torch.core.bigjoin import BigJoinConfig
        eng = DeltaBigJoin(q, e, cfg=BigJoinConfig(
            batch=args.batch, seed_chunk=args.batch, mode="collect",
            out_capacity=1 << 18), device=args.device)
    else:
        if args.backend:
            mesh = init_rank_mesh(args.workers, args.backend, args.device)
        else:
            mesh = make_host_mesh(args.workers, args.device)
        exchange.TIMING[0] = True
        eng = DistDeltaBigJoin(
            q, e, mesh=mesh,
            dcfg=default_delta_config(args.workers, batch=args.batch,
                                      balance=args.balance))
    mesh = eng.mesh if hasattr(eng, "mesh") else \
        make_host_mesh(1, eng.store.device)
    stream = EdgeUpdateStream(nv, args.batch_size, seed=args.seed + 1)

    epochs = []
    all_exact = True
    cur = e
    exchange.reset_counters()
    kernels.reset_launches()
    for step in range(args.batches):
        upd, w = stream.batch_at(step, live=cur)
        t0 = time.time()
        res = eng.apply(upd, w)
        dt = time.time() - t0
        changes = 0 if res.weights is None else int(
            np.abs(res.weights).sum())
        digest = hashlib.sha256()
        for a in (res.tuples, res.weights):
            if a is not None:
                digest.update(np.ascontiguousarray(a).tobytes())
        rec = {"epoch": step, "updates": int(upd.shape[0]),
               "count_delta": int(res.count_delta), "changes": changes,
               "sha": digest.hexdigest()[:16],
               "elapsed_s": round(dt, 4),
               "updates_per_s": round(upd.shape[0] / max(dt, 1e-9), 1)}
        now = eng.store.edges
        if not args.no_check:
            ot, ow = delta_oracle(q, cur, now)
            exact = canon(res.tuples, res.weights) == canon(ot, ow)
            rec["exact"] = bool(exact)
            all_exact = all_exact and exact
        cur = now.copy()  # keep the stream's live set current
        epochs.append(rec)

    # cluster-memory accounting: live entries over every worker shard
    # of every rank
    shard_entries = sum(exchange.per_rank(sum(
        reg.versioned("new").live_entries()
        for reg in eng.store.projections.values()), mesh))
    epochs_n = max(len(epochs), 1)
    sent = exchange.per_rank(sum(exchange.EXCHANGE_BYTES.values()), mesh)
    ex_us = exchange.per_rank(
        round(1e6 * sum(exchange.EXCHANGE_SECONDS.values())), mesh)
    out = {
        "query": args.query, "workers": args.workers,
        "device": str(eng.store.device),
        "ranks": mesh.ranks, "backend": mesh.backend,
        "mode": "local" if args.local else
        ("balance" if args.balance else "dist"),
        "edges_start": int(e.shape[0]),
        "edges_end": int(eng.store.num_edges),
        "batches": args.batches, "batch_size": args.batch_size,
        "all_exact": bool(all_exact), "shard_entries": int(shard_entries),
        "exchange_bytes_per_epoch": [b / epochs_n for b in sent],
        "exchange_ms_per_epoch": [us / 1e3 / epochs_n for us in ex_us],
        "store_bytes": exchange.per_rank(eng.store.device_bytes(), mesh),
        "launches": {k: v for k, v in (
            (name, exchange.per_rank(n, mesh))
            for name, n in kernels.launches().items()) if any(v)},
        "warm_epochs_per_s": round(
            len(epochs[2:]) / max(sum(r["elapsed_s"] for r in epochs[2:]),
                                  1e-9), 2) if len(epochs) > 2 else None,
        "epochs": epochs,
    }
    if mesh.rank == 0:
        print(json.dumps(out))
    close_rank_mesh()
    sys.exit(0 if all_exact else 1)
