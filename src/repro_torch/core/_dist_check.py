"""Distributed-join correctness harness of the port:

    python -m repro_torch.core._dist_check --workers 4 --query triangle \
        --ne 400 [--skew] [--balance] [--no-aggregate] [--device cpu] \
        [--rmat-scale 14 --out-capacity 4194304 --no-check]

Runs ``distributed_join`` on w workers (a leading tensor axis on one
device, default the card) over a random graph from ``--seed`` (uniform,
or R-MAT of ``--rmat-scale`` with edge factor 16), and the Generic-Join
oracle on the host.  Prints one JSON line with both counts and exits 0
only when the count and the tuples equal the oracle's; ``--no-check``
skips the oracle, for a caller that holds the line to another run's.  Every exchange is timed between two device
synchronisations (``exchange.TIMING``), with one process as with R.

With ``--backend gloo|nccl`` it is one rank of a mesh of R processes,
the w workers split over them:

    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.core._dist_check --backend gloo --device cpu \
        --workers 4

Rank 0 prints the line, with each rank's exchange bytes and seconds a
step, its device bytes of index and its kernel launches of the second
run; every rank exits non-zero on a mismatch.  ``tuples_sha`` digests
the collected tuples and weights in worker order, so two runs over the
same inputs compare in one field.
"""
import sys

if __name__ == "__main__":
    import argparse

    from repro_torch.launch.mesh import BACKENDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--query", default="triangle")
    ap.add_argument("--nv", type=int, default=60)
    ap.add_argument("--ne", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rmat-scale", type=int, default=None,
                    help="an R-MAT graph of this scale, edge factor 16, "
                    "instead of the uniform --nv/--ne one")
    ap.add_argument("--out-capacity", type=int, default=1 << 18,
                    help="collected rows a worker")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the Generic-Join oracle")
    ap.add_argument("--skew", action="store_true")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--route-capacity", type=int, default=64)
    ap.add_argument("--no-aggregate", action="store_true")
    ap.add_argument("--balance", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the workers (default: the card; cpu: "
                    "the plain versions)")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="run as one rank of a mesh over torch.distributed "
                    "(under python -m torch.distributed.run)")
    args = ap.parse_args()

    import hashlib
    import json
    import time

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import exchange
    from repro_torch.core import query as Q
    from repro_torch.core.bigjoin import BigJoinConfig
    from repro_torch.core.distributed import (DistConfig, distributed_join,
                                              index_bytes,
                                              partition_indices)
    from repro_torch.core.generic_join import generic_join
    from repro_torch.core.plan import make_plan
    from repro_torch.launch.mesh import (close_rank_mesh, init_rank_mesh,
                                         make_host_mesh)

    if args.backend:
        mesh = init_rank_mesh(args.workers, args.backend, args.device)
    else:
        mesh = make_host_mesh(args.workers, args.device)
    exchange.TIMING[0] = True
    rng = np.random.default_rng(args.seed)
    if args.rmat_scale is not None:
        from repro_torch.data.synthetic import rmat_graph
        e = rmat_graph(args.rmat_scale, 16, seed=args.seed)
    elif args.skew:
        u = (rng.zipf(1.4, args.ne) % args.nv).astype(np.int64)
        v = rng.integers(0, args.nv, args.ne)
    else:
        u = rng.integers(0, args.nv, args.ne)
        v = rng.integers(0, args.nv, args.ne)
    if args.rmat_scale is None:
        keep = u != v
        e = np.unique(np.stack([u[keep], v[keep]], 1).astype(np.int32),
                      axis=0)

    q = Q.query_by_name(args.query)
    plan = make_plan(q)
    rels = {Q.EDGE: e}
    base = BigJoinConfig(batch=args.batch, mode="collect",
                         out_capacity=args.out_capacity)
    cfg = DistConfig(base, args.workers, route_capacity=args.route_capacity,
                     aggregate=not args.no_aggregate, balance=args.balance)
    indices = partition_indices(plan, rels, args.workers,
                                device=mesh.device, mesh=mesh)
    t0 = time.time()
    res = distributed_join(plan, rels, mesh=mesh, cfg=cfg, indices=indices)
    elapsed = time.time() - t0
    # a second run: the kernels are loaded and the allocator warm; its
    # exchanges are the ones counted
    exchange.reset_counters()
    kernels.reset_launches()
    t0 = time.time()
    res = distributed_join(plan, rels, mesh=mesh, cfg=cfg, indices=indices)
    warm = time.time() - t0
    steps = max(res.steps, 1)
    sent = exchange.per_rank(sum(exchange.EXCHANGE_BYTES.values()), mesh)
    ex_us = exchange.per_rank(
        round(1e6 * sum(exchange.EXCHANGE_SECONDS.values())), mesh)
    idx_bytes = exchange.per_rank(index_bytes(indices), mesh)
    launched = {name: exchange.per_rank(n, mesh)
                for name, n in kernels.launches().items()}
    cnt = exact = None
    if not args.no_check:
        ref, cnt = generic_join(q, rels, plan=plan)
        got = (np.unique(res.tuples, axis=0) if res.tuples.size
               else np.zeros((0, q.num_attrs)))
        exact = bool(got.shape[0] == cnt
                     and (cnt == 0
                          or np.array_equal(got, np.unique(ref, axis=0))))
    digest = hashlib.sha256(np.ascontiguousarray(res.tuples).tobytes()
                            + np.ascontiguousarray(res.weights).tobytes())
    ok = args.no_check or (res.count == cnt and exact)
    if mesh.rank == 0:
        print(json.dumps({
            "query": args.query, "workers": args.workers,
            "device": mesh.device, "ranks": mesh.ranks,
            "backend": mesh.backend,
            "dist_count": res.count, "oracle_count": cnt,
            "tuples_exact": exact, "steps": res.steps,
            "proposals": res.proposals,
            "intersections": res.intersections,
            "max_load": res.max_load, "mean_load": res.mean_load,
            "worker_rows": res.worker_rows.tolist(),
            "tuples_sha": digest.hexdigest()[:16],
            "edges": int(e.shape[0]),
            "elapsed_s": round(elapsed, 3), "warm_s": round(warm, 3),
            "exchange_bytes_per_step": [b / steps for b in sent],
            "exchange_ms_per_step": [us / 1e3 / steps for us in ex_us],
            "index_bytes": idx_bytes,
            "launches": {k: v for k, v in launched.items() if any(v)},
        }))
    close_rank_mesh()
    sys.exit(0 if ok else 1)
