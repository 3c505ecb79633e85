"""Quickstart on the PyTorch/CUDA port: count and enumerate triangles
through the GraphSession facade.

    PYTHONPATH=src python examples/torch_quickstart.py [--scale 11]

A session owns the graph (and every index built over it, on the card
unless ``--device cpu``); queries register against the session — by name,
or as a textual pattern — and evaluate with the worst-case-optimal BiGJoin
dataflow.
"""
import argparse

import numpy as np

from repro_torch.api import GraphSession, oracle_count
from repro_torch.data.synthetic import rmat_graph


def main(scale=11, edge_factor=8, device=None):
    # a skewed power-law graph — the regime the paper targets
    edges = rmat_graph(scale=scale, edge_factor=edge_factor, seed=0)
    session = GraphSession(edges, device=device)
    print(f"graph: {session.num_edges:,} edges on {session.device}, "
          f"max out-degree {np.bincount(session.edges[:, 0]).max():,}")

    # triangles, registered by name (capacities auto-sized via AGM bounds)
    tri = session.register("triangle")
    count = tri.count()
    tuples, weights = tri.enumerate()
    print(f"BiGJoin: {count:,} triangles; first 3: "
          f"{tuples[:3].tolist()}")

    # the same motif written as a pattern — the DSL parses to the same query
    tri2 = session.register("tri2(a, b, c) := e(a, b), e(a, c), e(b, c)")
    assert tri2.count() == count

    # cross-check against the serial Generic Join oracle
    ref = oracle_count("triangle", session.edges)
    assert count == int(weights.sum()) == ref, (count, ref)
    print(f"matches serial GJ oracle ({ref:,}) ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=11)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    a = ap.parse_args()
    main(a.scale, a.edge_factor, a.device)
