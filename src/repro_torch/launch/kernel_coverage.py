"""Kernel-coverage gate: a warm composite stream, its kernels on the path.

Drives the §5.4 two-session pipeline (triangle feeder -> streamed ``tri``
relation -> standing 4-clique-tri) after the admission prewarm, then
checks the two halves of the contract:

- **zero serving compiles**: after ``prewarm``, every epoch reports
  ``EpochResult.compile_events == 0`` (no kernel library built or loaded
  while serving);
- **the kernels on the path** (on the card): ``GraphSession.
  kernel_coverage()`` shows, for every relation (the composite ``tri``
  among them), exactly ONE commit-fold launch and at least one launch in
  the versioned probe, the launches a warm epoch makes.  On the host the
  plain versions launch nothing, so the launch half reports 0 and is not
  held there.

Prints one JSON line and exits non-zero on any violation:

    python -m repro_torch.launch.kernel_coverage [--scale 8] [--epochs 6] \
        [--batch-size 64] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=8,
                    help="graph scale: nv = 2**scale")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--update-batch", type=int, default=0,
                    help="pinned delta mark; 0 = 4x batch-size (triangle "
                    "deltas fan out past the edge batch that caused them)")
    ap.add_argument("--device", default=None,
                    help="device of the session (default: the card; cpu: "
                    "the plain versions)")
    args = ap.parse_args(argv)
    update_batch = args.update_batch or 4 * args.batch_size

    from repro_torch.api import GraphSession
    from repro_torch.data.synthetic import EdgeUpdateStream, uniform_graph

    # nv*3 edges sit mid-rung and the stream churns balanced
    # (insert_frac=0.5), so the live sets stay on their capacity rungs
    nv = 1 << args.scale
    edges = uniform_graph(nv, nv * 3, seed=7)
    sess = GraphSession(edges, local=True, batch=1024,
                        out_capacity=1 << 16, update_batch=update_batch,
                        device=args.device)
    on_card = sess.device.type == "cuda"
    tri = sess.register("triangle")
    tri0, _ = tri.enumerate()
    sess.add_relation("tri", tri0)
    sess.register("4-clique-tri")
    prewarm_compiles = sess.prewarm(
        horizon=(args.warmup + args.epochs) * update_batch)

    stream = EdgeUpdateStream(nv, args.batch_size, insert_frac=0.5, seed=11)
    live = sess.edges
    warm_compiles, epoch_compiles = 0, []
    for step in range(args.warmup + args.epochs):
        upd, w = stream.batch_at(step, live=live)
        res = sess.update(upd, w)
        live = res.advance(live)
        d = res.deltas["triangle"]
        t_upd = d.tuples if d.tuples is not None else \
            np.zeros((0, 3), np.int32)
        t_w = d.weights if d.weights is not None else np.zeros(0, np.int32)
        res2 = sess.update({"tri": (t_upd, t_w)})
        ev = res.compile_events + res2.compile_events
        epoch_compiles.append(ev)
        if step >= args.warmup:
            warm_compiles += ev

    cov = sess.kernel_coverage()
    composite = {rel: c for rel, c in cov.items() if c["composite"]}
    rec = {
        "gate": "kernel_coverage",
        "device": str(sess.device),
        "prewarm_compiles": int(prewarm_compiles),
        "warm_compiles": int(warm_compiles),
        "epoch_compiles": epoch_compiles,
        "coverage": cov,
        "composite_relations": sorted(composite),
    }
    failures = []
    if warm_compiles != 0:
        failures.append(f"serving compiles after warmup: {warm_compiles}")
    if "tri" not in composite:
        failures.append("no composite tri relation in the stream")
    if on_card:  # the launch gate is the card's: the host launches nothing
        for rel, c in cov.items():
            if c["fold_pallas_calls"] != 1:
                failures.append(
                    f"{rel}: the commit fold made {c['fold_pallas_calls']} "
                    "launches, want the ONE fused launch")
            if c["probe_pallas_calls"] < 1:
                failures.append(f"{rel}: no kernel launch in the probe")
    rec["launch_gate"] = "held" if on_card else "not held on the host"
    rec["ok"] = not failures
    rec["failures"] = failures
    print(json.dumps(rec))
    print(f"kernel-coverage: {warm_compiles} serving compiles after "
          f"warmup; fold launches: "
          f"{ {r: c['fold_pallas_calls'] for r, c in cov.items()} }; "
          f"{'OK' if not failures else 'FAILED: ' + '; '.join(failures)}",
          file=sys.stderr)
    return 0 if not failures else 1


if __name__ == "__main__":
    raise SystemExit(main())
