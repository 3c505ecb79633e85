"""Uniform fanout neighbor sampler (GraphSAGE-style) for minibatch GNN
training — the ``minibatch_lg`` input shape.

The sampler IS a one-level WCOJ prefix extension: seeds play P_1, sampled
neighbors are capped Proposals from the reverse CSR — the same
ragged-expansion machinery as bigjoin's Proposal operator, with a fanout
cap instead of the intersection stage.  Host numpy, the same draws from
the same seed as the JAX package's sampler.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class SampledBlock:
    """One bipartite message-passing block (dst nodes <- sampled srcs)."""

    src_nodes: np.ndarray  # [n_src] global ids (superset of dst_nodes)
    dst_nodes: np.ndarray  # [n_dst] global ids
    edge_src: np.ndarray  # [n_edge] local indices into src_nodes
    edge_dst: np.ndarray  # [n_edge] local indices into dst_nodes


def local_index(nodes: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """int32 position of each of ``ids`` in ``nodes`` (every id present);
    among repeated nodes the last position, as a dict built over
    ``enumerate(nodes)`` would give."""
    order = np.argsort(nodes, kind="stable")
    pos = np.searchsorted(nodes[order], ids, side="right") - 1
    return order[pos].astype(np.int32)


class NeighborSampler:
    def __init__(self, edges: np.ndarray, num_vertices: int):
        edges = np.asarray(edges, np.int64)
        order = np.lexsort((edges[:, 0], edges[:, 1]))  # sort by dst
        self.by_dst = edges[order]
        self.dst_off = np.searchsorted(self.by_dst[:, 1],
                                       np.arange(num_vertices + 1))
        self.num_vertices = num_vertices

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.Generator
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """For each node, <= fanout uniform in-neighbors: stride sampling
        with a random phase per node.

        Returns (edge_src_global, edge_dst_global).
        """
        nodes = np.asarray(nodes, np.int64)
        start = self.dst_off[nodes]
        deg = self.dst_off[nodes + 1] - start
        take = np.minimum(deg, fanout)
        total = int(take.sum())
        row = np.repeat(np.arange(nodes.shape[0]), take)
        cum = np.concatenate([[0], np.cumsum(take)])
        k = np.arange(total) - cum[row]
        phase = rng.integers(0, np.maximum(deg, 1))[row]
        idx = (phase + (k * np.maximum(deg[row] // np.maximum(take[row], 1),
                                       1))) % np.maximum(deg[row], 1)
        pos = start[row] + idx
        src = self.by_dst[pos, 0]
        dst = nodes[row]
        return src.astype(np.int64), dst.astype(np.int64)

    def sample_blocks(self, seeds: np.ndarray, fanouts: List[int],
                      seed: int = 0) -> List[SampledBlock]:
        """Layered blocks, innermost-first (fanouts like [15, 10])."""
        rng = np.random.default_rng(seed)
        blocks: List[SampledBlock] = []
        dst = np.asarray(seeds, np.int64)
        for f in fanouts:
            es, ed = self.sample_neighbors(dst, f, rng)
            src_nodes = np.unique(np.concatenate([dst, es]))
            edge_src = np.searchsorted(src_nodes, es).astype(np.int32)
            edge_dst = local_index(dst, ed)
            blocks.append(SampledBlock(src_nodes, dst, edge_src, edge_dst))
            dst = src_nodes  # next (outer) layer samples for these
        return blocks[::-1]  # outermost first for forward propagation
