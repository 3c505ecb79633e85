"""Synthetic data — deterministic numpy generators (framework-free).

The streaming session's inputs: ``rmat_graph`` (skewed power-law degrees,
Graph500 parameters), the dirty :class:`EdgeUpdateStream` and the clean,
net-balanced :func:`clean_update_batches` of the serving pool; the GNN
trainer's graph, ``uniform_graph``; the LM's token batches,
:class:`TokenStream`; the two-tower model's events,
:func:`recsys_events`.  All are pure functions of their seed, so any run
can re-derive any epoch's batch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


def rmat_graph(scale: int, edge_factor: int = 16, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19
               ) -> np.ndarray:
    """R-MAT generator (Graph500 parameters by default): [E, 2] int32,
    self-loops dropped, deduplicated."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    e = n * edge_factor
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    for bit in range(scale):
        r = rng.random(e)
        # quadrant probabilities (a, b, c, d)
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        src |= go_down.astype(np.int64) << bit
        dst |= go_right.astype(np.int64) << bit
    keep = src != dst
    # distinct rows in lexicographic order (ids < 2^31, so the packed
    # src<<32|dst words sort like the rows)
    packed = np.unique((src[keep] << 32) | dst[keep])
    return np.stack([packed >> 32, packed & 0xFFFFFFFF], 1).astype(np.int32)


def uniform_graph(num_vertices: int, num_edges: int, seed: int = 0
                  ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    u = rng.integers(0, num_vertices, num_edges)
    v = rng.integers(0, num_vertices, num_edges)
    keep = u != v
    return np.unique(np.stack([u[keep], v[keep]], 1).astype(np.int32),
                     axis=0)


@dataclasses.dataclass
class TokenStream:
    """Deterministic LM token batches: batch [B, S+1] int32 (inputs+labels).

    Shard-aware: worker ``shard`` of ``num_shards`` sees a disjoint
    deterministic substream; ``batch_at`` provides O(1) seek for restart.
    """

    vocab_size: int
    batch_size: int
    seq_len: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * self.num_shards + self.shard)
        # zipf-ish marginal over the vocab — cheap stand-in for text
        z = rng.zipf(1.3, size=(self.batch_size, self.seq_len + 1))
        return (z % self.vocab_size).astype(np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class EdgeUpdateStream:
    """Mixed insert/delete edge-update batches for streaming graph monitors.

    Batches are intentionally DIRTY — duplicates, self-loops, inserts of
    already-live edges and deletes of absent edges — because the engine's
    ``normalize`` must net them out; ``insert_frac`` of each batch are
    candidate inserts, the rest deletes drawn from the caller's live set
    (plus a sprinkle of absent-edge deletes that must be no-ops).
    """

    num_vertices: int
    batch_size: int
    insert_frac: float = 0.75
    skew: float = 0.0  # 0 = uniform endpoints; >1 = zipf exponent
    seed: int = 0
    shard: int = 0
    num_shards: int = 1

    def batch_at(self, step: int, live: np.ndarray | None = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 9_999_991 + step) * self.num_shards + self.shard)
        nv = self.num_vertices
        n_ins = int(round(self.batch_size * self.insert_frac))
        n_del = self.batch_size - n_ins
        if self.skew > 1.0:
            u = (rng.zipf(self.skew, n_ins) % nv).astype(np.int32)
            v = rng.integers(0, nv, n_ins).astype(np.int32)
            ins = np.stack([u, v], 1)
        else:
            ins = rng.integers(0, nv, (n_ins, 2)).astype(np.int32)
        parts = [ins]
        n_live = 0
        if n_del and live is not None and np.asarray(live).size:
            live = np.asarray(live, np.int32).reshape(-1, 2)
            n_live = max(n_del - n_del // 4, 1)
            parts.append(live[rng.integers(0, live.shape[0], n_live)])
        if n_del - n_live > 0:  # absent-edge deletes: must normalize away
            parts.append(rng.integers(0, nv, (n_del - n_live, 2)
                                      ).astype(np.int32))
        upd = np.concatenate(parts, axis=0)
        w = np.concatenate([np.ones(n_ins, np.int32),
                            -np.ones(upd.shape[0] - n_ins, np.int32)])
        return upd, w


def clean_update_batches(edges: np.ndarray, num_vertices: int,
                         batch_size: int, epochs: int, seed: int = 0):
    """Pre-generate ``epochs`` CLEAN, net-balanced edge-update batches.

    Clean = sign-consistent at its point in the stream: every delete names
    a then-live edge, every insert a then-absent one, no duplicates inside
    a batch.  Two properties follow that the dirty
    :class:`EdgeUpdateStream` deliberately lacks (serving contract,
    DESIGN.md §9): (a) concatenating consecutive clean batches and
    normalizing ONCE nets to the same state as applying them one at a time
    — what makes the serving pool's adaptive coalescing exact — and (b)
    the live count stays pinned at ``|edges|`` (each batch deletes and
    inserts ``batch_size // 2``), so the base region never outgrows its
    pow2 rung and the post-prewarm zero-compile budget holds for streams
    of any length.  Returns ``[(rows [B,2], weights [B]), ...]``.
    """
    rng = np.random.default_rng(seed * 7_654_321 + 17)
    # the JAX package's set, built in the same order (so it pops the same
    # edges) from Python ints at a quarter of the cost
    live = set(map(tuple,
                   np.asarray(edges, np.int32).reshape(-1, 2).tolist()))
    half = batch_size // 2
    out = []
    for _ in range(epochs):
        dels = [live.pop() for _ in range(min(half, len(live) - 1))]
        ins = []
        while len(ins) < half:
            u, v = rng.integers(0, num_vertices, 2)
            e = (int(u), int(v))
            if u != v and e not in live:
                live.add(e)
                ins.append(e)
        rows = np.array(dels + ins, np.int32)
        w = np.concatenate([-np.ones(len(dels), np.int32),
                            np.ones(len(ins), np.int32)])
        out.append((rows, w))
    return out


def recsys_events(num_users: int, num_items: int, batch: int, step: int,
                  table_sizes: Tuple[int, ...], multi_hot: int = 8,
                  seed: int = 0):
    """One batch of retrieval events: (user_feats, item_ids, labels).

    user_feats: dict of categorical id arrays per embedding table,
    ``multi_hot`` ids per example for the bag features (the EmbeddingBag
    path); the JAX package's stream of draws.
    """
    rng = np.random.default_rng(seed * 7_777_777 + step)
    feats = {}
    for t, size in enumerate(table_sizes):
        # zipf over table rows: hot items/users (the skew the paper fights)
        ids = rng.zipf(1.2, size=(batch, multi_hot)) % size
        feats[f"table_{t}"] = ids.astype(np.int32)
    item_ids = (rng.zipf(1.2, size=(batch,)) % num_items).astype(np.int32)
    labels = rng.integers(0, 2, size=(batch,)).astype(np.float32)
    return feats, item_ids, labels
