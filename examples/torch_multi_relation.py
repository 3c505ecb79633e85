"""Multi-relation sessions on the PyTorch/CUDA port: the ternary ``tri``
relation feeding 4-clique-tri (§5.4), verified against the edge-only
4-clique.

ONE :class:`repro_torch.api.GraphSession` owns TWO dynamic relations — the
binary ``edge`` stream and a materialized ternary ``tri`` relation — and
serves three standing queries off the same store:

    triangle       tri(a,b,c)   := e(a,b), e(a,c), e(b,c)   (the feeder)
    4-clique       6 edge atoms                              (the reference)
    4-clique-tri   4clq := tri(a,b,c), tri(a,b,d), tri(a,c,d)

Each logical epoch is two session updates: the edge batch first, then the
triangle query's signed output delta applied to the ``tri`` relation.  The
4-clique-tri deltas must match the edge-only 4-clique deltas BIT-EXACTLY,
every epoch — the two plans walk completely different index projections
(ternary composite-key regions vs binary regions), so agreement is a real
end-to-end check of the n-ary engine.  The session runs on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/torch_multi_relation.py
"""
import argparse
import time

import numpy as np

from repro_torch.api import GraphSession, canon_signed as _canon, oracle_count
from repro_torch.data.synthetic import EdgeUpdateStream, rmat_graph


def main(scale=9, edge_factor=6, epochs=6, batch_size=128, device=None):
    edges = rmat_graph(scale, edge_factor, seed=11)
    session = GraphSession(edges, device=device, update_batch=batch_size)
    tri = session.register("triangle")
    c4 = session.register("4-clique")
    tri0, _ = tri.enumerate()  # materialize the initial tri relation
    session.add_relation("tri", tri0)
    c4t = session.register("4-clique-tri")
    print(f"session on {session.device}: {session.num_edges:,} edges + "
          f"{session.num_tuples('tri'):,} tri tuples; "
          f"static 4-clique = {c4.count():,}, 4-clique-tri = "
          f"{c4t.count():,}")
    assert c4t.count() == c4.count()

    stream = EdgeUpdateStream(1 << scale, batch_size, seed=12)
    live = session.edges
    for step in range(epochs):
        upd, wts = stream.batch_at(step, live=live)
        t0 = time.time()
        r1 = session.update(upd, wts)            # edge epoch
        td = r1.deltas["triangle"]
        t_upd = td.tuples if td.tuples is not None else \
            np.zeros((0, 3), np.int32)
        t_w = td.weights if td.weights is not None else \
            np.zeros(0, np.int32)
        r2 = session.update({"tri": (t_upd, t_w)})  # tri epoch
        dt = max(time.time() - t0, 1e-9)
        live = r1.advance(live)
        a, b = r1.deltas["4-clique"], r2.deltas["4-clique-tri"]
        assert _canon(b.tuples, b.weights) == _canon(a.tuples, a.weights), \
            f"epoch {step}: tri-plan and edge-plan deltas diverged"
        print(f"  epoch {step}: triangle {td.count_delta:+,}  "
              f"4-clique {a.count_delta:+,}  4-clique-tri "
              f"{b.count_delta:+,}  (bit-exact ✓) in {dt*1e3:.0f} ms")

    # the maintained totals survive full recomputation
    ref = oracle_count("4-clique", session.edges)
    ref0 = oracle_count("4-clique", edges)
    assert c4.net_change == c4t.net_change == ref - ref0
    assert c4t.count() == c4.count() == ref
    print(f"verified: both plans net {c4.net_change:+,}, recompute diff "
          f"{ref - ref0:+,}, {ref:,} 4-cliques now ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=9)
    ap.add_argument("--edge-factor", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    a = ap.parse_args()
    main(a.scale, a.edge_factor, a.epochs, a.batch_size, a.device)
