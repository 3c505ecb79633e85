"""Distributed Delta-BiGJoin differential harness of the port:

    python -m repro_torch.core._delta_dist_check --workers 4 \
        --query triangle --batches 20 [--balance] [--skew] [--device cpu]

Per update epoch it applies one mixed insert/delete batch through
``DistDeltaBigJoin`` on ``--workers`` workers (a leading tensor axis on
``--device``, default the card) and checks the SIGNED output tuples bit
for bit against ``delta_oracle`` (full recomputation on the before/after
edge sets).  Prints one JSON line: per-epoch wall times, throughput,
exactness, and the shards' live entries; exits 0 only when every epoch
is exact.
"""
import sys

if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--query", default="triangle")
    ap.add_argument("--nv", type=int, default=40)
    ap.add_argument("--ne", type=int, default=400)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
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
    args = ap.parse_args()

    import json
    import time

    import numpy as np

    from repro_torch.core import query as Q
    from repro_torch.core.delta import (DeltaBigJoin, canon_signed as canon,
                                        delta_oracle)
    from repro_torch.core.distributed import (DistDeltaBigJoin,
                                              default_delta_config)
    from repro_torch.data.synthetic import EdgeUpdateStream, uniform_graph
    from repro_torch.launch.mesh import make_host_mesh

    rng = np.random.default_rng(args.seed)
    if args.skew:
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
        eng = DistDeltaBigJoin(
            q, e, mesh=make_host_mesh(args.workers, args.device),
            dcfg=default_delta_config(args.workers, batch=args.batch,
                                      balance=args.balance))
    stream = EdgeUpdateStream(args.nv, args.batch_size, seed=args.seed + 1)

    epochs = []
    all_exact = True
    cur = e
    for step in range(args.batches):
        upd, w = stream.batch_at(step, live=cur)
        t0 = time.time()
        res = eng.apply(upd, w)
        dt = time.time() - t0
        changes = 0 if res.weights is None else int(
            np.abs(res.weights).sum())
        rec = {"epoch": step, "updates": int(upd.shape[0]),
               "count_delta": int(res.count_delta), "changes": changes,
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
    shard_entries = sum(
        reg.versioned("new").live_entries()
        for reg in eng.store.projections.values())
    out = {
        "query": args.query, "workers": args.workers,
        "device": str(eng.store.device),
        "mode": "local" if args.local else
        ("balance" if args.balance else "dist"),
        "edges_start": int(e.shape[0]),
        "edges_end": int(eng.store.num_edges),
        "batches": args.batches, "batch_size": args.batch_size,
        "all_exact": bool(all_exact), "shard_entries": int(shard_entries),
        "warm_epochs_per_s": round(
            len(epochs[2:]) / max(sum(r["elapsed_s"] for r in epochs[2:]),
                                  1e-9), 2) if len(epochs) > 2 else None,
        "epochs": epochs,
    }
    print(json.dumps(out))
    sys.exit(0 if all_exact else 1)
