"""End-to-end serving driver on the PyTorch/CUDA port: continuous
MULTI-query subgraph monitoring.

The paper's deployment scenario (§5.3) through the facade: one
:class:`repro_torch.api.GraphSession` owns the graph; triangle and diamond
register as standing queries against it.  Every update epoch the session
runs ONE normalize, evaluates BOTH queries' delta pipelines off the same
shared multi-version index regions, and performs ONE commit — Delta-BiGJoin
evaluates only the delta queries, never recomputing from scratch, and the
queries do not pay per-query index copies or commits.  The session runs on
one device: the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_incremental_motifs.py
"""
import argparse
import time

import numpy as np

from repro_torch.api import GraphSession, oracle_count
from repro_torch.data.synthetic import rmat_graph


def main(scale=11, edge_factor=8, batches=6, batch_size=800, device=None):
    edges = rmat_graph(scale, edge_factor, seed=7)
    n0 = edges.shape[0] - batches * batch_size
    session = GraphSession(edges[:n0], device=device,
                           update_batch=batch_size + batch_size // 8)
    names = ("triangle", "diamond")
    handles = [session.register(n) for n in names]
    print(f"loading {session.num_edges:,} edges; monitoring "
          f"{' + '.join(names)} on ONE session on {session.device} under "
          f"{batches} update batches of {batch_size} (single commit per "
          "epoch)")

    rng = np.random.default_rng(0)
    start = session.edges.copy()
    for i in range(batches):
        lo = n0 + i * batch_size
        ins = edges[lo:lo + batch_size]
        # delete a few random live edges too (mixed workload)
        live = session.edges
        dels = live[rng.choice(live.shape[0], size=batch_size // 8,
                               replace=False)]
        batch = np.concatenate([ins, dels])
        weights = np.concatenate([
            np.ones(len(ins), np.int32), -np.ones(len(dels), np.int32)])
        t0 = time.time()
        res = session.update(batch, weights)
        dt = max(time.time() - t0, 1e-9)
        line = [f"batch {i}:"]
        for h in handles:
            d = res.deltas[h.name]
            changes = 0 if d.weights is None else int(
                np.abs(d.weights).sum())
            line.append(f"{h.name} {d.count_delta:+,} "
                        f"({changes / dt:,.0f} changes/s)")
        print("  " + "  ".join(line))

    # verify the maintained totals against full recomputation
    st = session.stats
    assert st.commit_calls == st.normalize_calls == batches, st
    for h in handles:
        ref = oracle_count(h.query, session.edges)
        ref0 = oracle_count(h.query, start)
        assert h.net_change == ref - ref0, (h.name, h.net_change, ref - ref0)
        print(f"{h.name}: maintained total change {h.net_change:+,} == "
              f"recompute diff ✓ (now {ref:,} instances)")
    print(f"epoch accounting: {st.commit_calls} commits / "
          f"{st.normalize_calls} normalizes for {len(handles)} standing "
          "queries ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=11)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=800)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    a = ap.parse_args()
    main(a.scale, a.edge_factor, a.batches, a.batch_size, a.device)
