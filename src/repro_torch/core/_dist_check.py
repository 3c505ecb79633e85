"""Distributed-join correctness harness of the port:

    python -m repro_torch.core._dist_check --workers 4 --query triangle \
        --ne 400 [--skew] [--balance] [--no-aggregate] [--device cpu]

Runs ``distributed_join`` on w workers (a leading tensor axis on one
device, default the card) over a random graph from ``--seed``, and the
Generic-Join oracle on the host.  Prints one JSON line with both counts
and exits 0 only when the count and the tuples equal the oracle's.
"""
import sys

if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--query", default="triangle")
    ap.add_argument("--nv", type=int, default=60)
    ap.add_argument("--ne", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skew", action="store_true")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--route-capacity", type=int, default=64)
    ap.add_argument("--no-aggregate", action="store_true")
    ap.add_argument("--balance", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the workers (default: the card; cpu: "
                    "the plain versions)")
    args = ap.parse_args()

    import json
    import time

    import numpy as np

    from repro_torch.core import query as Q
    from repro_torch.core.bigjoin import BigJoinConfig
    from repro_torch.core.distributed import DistConfig, distributed_join
    from repro_torch.core.generic_join import generic_join
    from repro_torch.core.plan import make_plan
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(args.workers, args.device)
    rng = np.random.default_rng(args.seed)
    if args.skew:
        u = (rng.zipf(1.4, args.ne) % args.nv).astype(np.int64)
        v = rng.integers(0, args.nv, args.ne)
    else:
        u = rng.integers(0, args.nv, args.ne)
        v = rng.integers(0, args.nv, args.ne)
    keep = u != v
    e = np.unique(np.stack([u[keep], v[keep]], 1).astype(np.int32), axis=0)

    q = Q.query_by_name(args.query)
    plan = make_plan(q)
    rels = {Q.EDGE: e}
    base = BigJoinConfig(batch=args.batch, mode="collect",
                         out_capacity=1 << 18)
    cfg = DistConfig(base, args.workers, route_capacity=args.route_capacity,
                     aggregate=not args.no_aggregate, balance=args.balance)
    t0 = time.time()
    res = distributed_join(plan, rels, mesh=mesh, cfg=cfg)
    elapsed = time.time() - t0
    # a second run: the kernels are loaded and the allocator warm
    t0 = time.time()
    res = distributed_join(plan, rels, mesh=mesh, cfg=cfg)
    warm = time.time() - t0
    ref, cnt = generic_join(q, rels, plan=plan)
    got = (np.unique(res.tuples, axis=0) if res.tuples is not None
           and res.tuples.size else np.zeros((0, q.num_attrs)))
    exact = bool(got.shape[0] == cnt
                 and (cnt == 0
                      or np.array_equal(got, np.unique(ref, axis=0))))
    print(json.dumps({
        "query": args.query, "workers": args.workers,
        "device": mesh.device,
        "dist_count": res.count, "oracle_count": cnt,
        "tuples_exact": exact, "steps": res.steps,
        "proposals": res.proposals, "max_load": res.max_load,
        "mean_load": res.mean_load, "edges": int(e.shape[0]),
        "elapsed_s": round(elapsed, 3), "warm_s": round(warm, 3),
    }))
    sys.exit(0 if (res.count == cnt and exact) else 1)
