"""The paper's engine as a CLI, driven through the GraphSession facade:

    python -m repro_torch.launch.run_query --query triangle --scale 12 \
        --mode static|delta|distributed|serial [--verify] [--device cpu]

``static`` counts on a local session, ``distributed`` on a mesh session
of ``--workers`` workers (default 4, the port's stand-in for the JAX
package's host device count), ``delta`` streams update batches through a
standing registration, ``serial`` runs the Generic-Join oracle baseline
on the host.  ``--verify`` holds the delta mode's maintained change to
the oracle's recount of the graph before and after the stream, and the
static and distributed counts to the oracle's count.  Sessions run on
``--device`` (default the card).  ``--mode distributed --backend
gloo|nccl`` runs as one rank of a mesh of R processes (under ``python -m
torch.distributed.run --nproc-per-node R``); rank 0 prints, and every
rank raises on a mismatch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api import Graph, GraphSession, QUERY_NAMES, oracle_count
from repro_torch.data.synthetic import rmat_graph
from repro_torch.launch.mesh import BACKENDS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", default="triangle",
                    help=f"named motif ({', '.join(QUERY_NAMES)}, path-N) "
                    "or a DSL pattern 'name(a,b,..) := e(a,b), ...'")
    ap.add_argument("--mode", default="static",
                    choices=["static", "delta", "distributed", "serial"])
    ap.add_argument("--scale", type=int, default=11,
                    help="RMAT scale (2^scale vertices)")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--batch", type=int, default=None,
                    help="B' dataflow batch (default: AGM auto-sizing)")
    ap.add_argument("--update-batches", type=int, default=5)
    ap.add_argument("--update-size", type=int, default=1000)
    ap.add_argument("--symmetric", action="store_true",
                    help="degree-relabel + symmetry-breaking filters")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="delta mode: check the maintained change against "
                    "the serial oracle's recount (raises on a mismatch)")
    ap.add_argument("--device", default="cuda",
                    help="device of the session (cpu: the plain versions)")
    ap.add_argument("--workers", type=int, default=4,
                    help="mesh workers of the distributed mode")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="distributed mode: run as one rank of a mesh over "
                    "torch.distributed (under python -m "
                    "torch.distributed.run)")
    args = ap.parse_args(argv)
    if args.backend and args.mode != "distributed":
        ap.error("--backend needs --mode distributed")
    if args.backend:
        from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh
        mesh = init_rank_mesh(args.workers, args.backend, args.device)
        try:
            return _run(args, mesh)
        finally:
            close_rank_mesh()
    return _run(args, None)


def _run(args, mesh):
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    g = Graph.from_edges(rmat_graph(args.scale, args.edge_factor,
                                    seed=args.seed))
    if args.symmetric:
        g = g.degree_relabel()
    say(f"graph: {g.num_vertices:,} vertices {g.num_edges:,} edges "
        f"(max outdeg {np.bincount(g.edges[:, 0]).max():,})")

    if args.mode == "serial":
        t0 = time.time()
        cnt = oracle_count(args.query, g.edges)
        print(f"serial GJ: {cnt:,} results in {time.time()-t0:.2f}s")
        return cnt

    if args.mode == "delta":
        n0 = g.num_edges - args.update_batches * args.update_size
        session = GraphSession(g.edges[:n0], device=args.device,
                               batch=args.batch,
                               update_batch=args.update_size)
        handle = session.register(args.query, symmetric=args.symmetric)
        print(f"loaded {n0:,} edges; streaming "
              f"{args.update_batches} x {args.update_size} updates")
        for i in range(args.update_batches):
            lo = n0 + i * args.update_size
            batch = g.edges[lo:lo + args.update_size]
            t0 = time.time()
            res = session.update(batch)
            dt = time.time() - t0
            d = res.deltas[handle.name]
            print(f"  batch {i}: +{d.count_delta:,} results "
                  f"({batch.shape[0]/dt:,.0f} updates/s, "
                  f"{abs(d.count_delta)/dt:,.0f} changes/s)")
        if args.verify:
            lo = n0 + args.update_batches * args.update_size
            want = oracle_count(handle.query, g.edges[:lo]) - \
                oracle_count(handle.query, g.edges[:n0])
            if handle.net_change != want:
                raise AssertionError(
                    f"maintained change {handle.net_change:+,} != "
                    f"recompute diff {want:+,}")
            print(f"verified: maintained change {handle.net_change:+,} == "
                  f"recompute diff ✓")
        return handle.net_change

    # static count: one device, or a mesh of --workers on it (over the
    # ranks of ``mesh`` when given)
    if args.mode == "distributed" and mesh is None:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(args.workers, args.device)
    session = GraphSession(g.edges, device=args.device, mesh=mesh,
                           batch=args.batch)
    t0 = time.time()
    handle = session.register(args.query, symmetric=args.symmetric)
    t_reg = time.time() - t0
    t0 = time.time()
    count = handle.count()
    where = f"one {session.device.type} device" if session.local else \
        f"w={session.w} mesh on {session.device.type}"
    if mesh is not None and mesh.ranks > 1:
        where += f" over {mesh.ranks} {mesh.backend} ranks"
    say(f"BiGJoin: {count:,} results in {time.time()-t0:.2f}s "
        f"({where}, register {t_reg:.2f}s)")
    if args.verify:
        want = oracle_count(handle.query, g.edges)
        if count != want:
            raise AssertionError(f"count {count:,} != oracle {want:,}")
        say(f"verified: count {count:,} == serial GJ oracle ✓")
    return count


if __name__ == "__main__":
    main()
