"""Delta-BiGJoin (§3.3): incremental maintenance of join queries over
dynamic relations of arity 2..4, with device-resident region state.

For each update batch dR (signed edge tuples) the engine runs the n delta
queries

    dQ_i :- R'_1, ..., R'_{i-1}, dR_i, R_{i+1}, ..., R_n

each through the same BiGJoin dataflow (``bigjoin.py``), seeded with dR_i.
Atoms left of the seed read the NEW version, atoms right of it the OLD.

Every index is the three-region LSM of §4.3 — ``base`` (compacted),
``cins``/``cdel`` (committed since the last compaction), ``uins``/``udel``
(the staged batch) — with OLD = base + cins - cdel and NEW = OLD + uins -
udel.  Commit folds the staged batch into the committed regions keeping
cins ∩ base = ∅, cdel ⊆ base and cins ∩ cdel = ∅, so positive regions never
hold duplicates; compaction merges the committed regions into base when
they exceed ``compact_ratio`` × |base|, and eagerly when a committed delete
is re-inserted.

Per epoch the device runs: one normalize (signed membership of the packed
batch in the live set, one kernel call), every query's level steps (the
fused extend kernel), one commit fold per relation and per projection (the
fold kernel), and the amortized compaction (the merge-rank kernel).  Host
numpy arrays are lazily-pulled debug mirrors.

The store holds any mix of relations (the binary ``edge`` graph, the
ternary ``tri`` relation of §5.4, a 4-ary ``quad``), each with its own live
LSM keyed on the full row: arity 3-4 rows pack into the composite (hi, lo)
word pair, so their regions carry the ``lo`` word and every kernel runs its
composite variant.  Projections that do not cover a relation's full row are
DERIVED from its live rows on demand instead of folded (see
:class:`_Regions`).

A commit is atomic (stage, then swap), the ``store.normalize`` and
``store.commit.fold`` fault points (:mod:`repro_torch.faults`) fire where
the JAX store fires them, and :meth:`RegionStore.snapshot` /
:meth:`RegionStore.restore` write and read the JAX store's snapshot format,
so a session's state moves between the packages.  The admission prewarm
(:meth:`DeltaBigJoin.prewarm`) pins the delta and probe marks to the update
batch and loads every kernel library an epoch launches, so a warm epoch
records no compile event (:mod:`repro_torch.core.compilestats`).

``RegionStore(shard_w=w)`` is the mesh's store: every device region (the
live sets' and the projections') is hash-partitioned over w workers
(``csr.build_sharded_index``, ownership by the row's packed key), each
tensor with a leading [w] axis and the live counts [w] vectors, so no
worker holds O(|R|) of a relation.  The folds stay shard-local: the
commit is ONE launch of the fold kernel's worker axis a relation and
projection; normalize, the re-insertion probe and compaction run the
membership and rank kernels one worker's shard at a time.

On a mesh of R ranks (``mesh=``) a rank's store holds its wl = w / R
shards, ``[wl, cap]``, and every rank is fed the same batches.  The host
counts stay the whole mesh's [w] vectors: each count read off the device
is gathered over the ranks (``exchange.worker_counts``), and each
existence or membership bit OR-ed over them (``exchange.any_worker``),
so every rank sizes its regions as the one-process store does (its
regions are that store's rows of its workers, padding included) and
takes every branch that calls a collective together with the others.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core import compilestats, csr
from repro_torch.core.bigjoin import (BigJoinConfig, Indices, JoinResult,
                                      run_bigjoin)
from repro_torch.core.capacity import Ratchet
from repro_torch.core.csr import IndexData, build_index
from repro_torch.core.dataflow_index import VersionedIndex
from repro_torch.core.exchange import (any_worker, broadcast_object,
                                       gather_rows, gather_to_root, per_rank,
                                       scatter_from_root, worker_counts)
from repro_torch.core.plan import Plan, make_delta_plan
from repro_torch.core.query import EDGE, Query, delta_queries
from repro_torch.errors import (CapacityOverflow, ESCALATES_BATCH,
                                ESCALATES_OUT, SnapshotError)
from repro_torch.kernels.intersect.ops import member
from repro_torch.kernels.merge.fold import commit_fold
from repro_torch.launch.mesh import make_host_mesh

Projection = Tuple[str, Tuple[int, ...], int]  # (rel, key_pos, ext_pos)


def _pack2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.int64) << 32) | b.astype(np.int64)


def _unpack2(packed: np.ndarray) -> np.ndarray:
    packed = np.asarray(packed, np.int64)
    return np.stack([(packed >> 32).astype(np.int32),
                     (packed & 0xFFFFFFFF).astype(np.int32)], 1)


def _pack_rows(rows: np.ndarray, arity: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Full rows of a relation as the (hi, lo) lex word pair its live-set
    LSM keys on (lo ≡ 0 for arity <= 2, the single-word packing)."""
    rows = np.asarray(rows, np.int32).reshape(-1, arity)
    packed = csr.pack_key(tuple(rows[:, c] for c in range(arity)))
    if isinstance(packed, tuple):
        return packed
    return packed, np.zeros(rows.shape[0], np.int64)


def _unpack_rows(hi: np.ndarray, lo: np.ndarray, arity: int) -> np.ndarray:
    """Inverse of :func:`_pack_rows`: [N, arity] int32 rows."""
    if arity <= 2:
        return csr.unpack_key(np.asarray(hi, np.int64), arity)
    return csr.unpack_key((np.asarray(hi, np.int64),
                           np.asarray(lo, np.int64)), arity)


def _degenerate_rows(rows: np.ndarray) -> np.ndarray:
    """Rows with any repeated vertex (self-loops generalized to n-ary):
    normalize drops them, as the edge path drops u == v."""
    rows = np.asarray(rows)
    bad = np.zeros(rows.shape[0], bool)
    for i in range(rows.shape[1]):
        for j in range(i + 1, rows.shape[1]):
            bad |= rows[:, i] == rows[:, j]
    return bad


def _check_batch(rel: str, updates, weights, arity: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Validate one relation's update batch: integer dtype, [N, arity]
    shape, non-negative int32-representable ids, matching weights."""
    arr = np.asarray(updates)
    if arr.size == 0:  # empty batches are always a valid no-op
        arr = np.zeros((0, arity), np.int64)
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(
            f"{rel!r} update batch must be integer tuples, got dtype "
            f"{arr.dtype}")
    if arr.ndim != 2 or arr.shape[1] != arity:
        raise ValueError(
            f"{rel!r} update batch must be [N, {arity}] (relation arity "
            f"{arity}), got shape {arr.shape}")
    if arr.size:
        amin, amax = int(arr.min()), int(arr.max())
        if amin < 0:
            raise ValueError(
                f"{rel!r} update batch contains negative id {amin}")
        if amax >= 2 ** 31:
            raise ValueError(
                f"{rel!r} update batch contains id {amax} outside the "
                "int32 vertex-id domain")
    if weights is None:
        weights = np.ones(arr.shape[0], np.int32)
    w = np.asarray(weights)
    if not np.issubdtype(w.dtype, np.integer):
        raise TypeError(
            f"{rel!r} update weights must be signed integers, got dtype "
            f"{w.dtype}")
    if w.shape != (arr.shape[0],):
        raise ValueError(
            f"{rel!r} update weights must be [N] = [{arr.shape[0]}], got "
            f"shape {w.shape}")
    return arr.astype(np.int32), w.astype(np.int32)


def _pow2(n: int) -> int:
    return csr.pow2_capacity(n)


def _total(n) -> int:
    return int(np.sum(n))


def _maxn(n) -> int:
    return int(np.max(n)) if np.ndim(np.asarray(n)) else int(n)


def _count_of(d: IndexData, mesh=None):
    """Exact live count(s) of a device region: an int for one region, the
    [w] int64 vector of the whole mesh for a sharded one (one pull either
    way; one gather over the ranks of ``mesh``)."""
    if d.n.dim():
        return worker_counts(d.n, mesh)
    return int(d.n)


# ---------------------------------------------------------------------------
# device cores (all arguments are device tensors)
# ---------------------------------------------------------------------------

def _normalize_core(p_hi: torch.Tensor, p_lo: torch.Tensor,
                    w: torch.Tensor, live: VersionedIndex, mesh=None):
    """Net one padded update batch against the live set:
    (ins_hi, ins_lo, n_ins, del_hi, del_lo, n_dels) as sentinel-padded
    sorted lex word pairs.

    p_hi/p_lo [B] int64 are the packed rows (degenerate/padding rows
    pre-masked to the sentinel on the host); ``live`` is the relation's
    packed LSM as the "old" versioned index (base, cins | cdel), composite
    (hi, lo) for arity > 2.  Existence is its signed membership — one kernel
    call for all three regions; under the commit invariants it equals
    (base ∧ ¬cdel) ∨ cins.  With a ``mesh`` the regions carry a leading
    [wl] axis (this rank's shards of the mesh's workers) and a row lives
    on exactly one shard, so existence is the OR over the shards, one
    membership call each, and over the ranks."""
    SENT = csr.SENTINEL
    dev = p_hi.device
    N = p_hi.shape[0]
    # lexsort((p_lo, p_hi)): p_hi primary, p_lo secondary
    o1 = torch.argsort(p_lo, stable=True)
    order = o1[torch.argsort(p_hi[o1], stable=True)]
    hs, ls, ws = p_hi[order], p_lo[order], w[order]
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = (hs[1:] != hs[:-1]) | (ls[1:] != ls[:-1])
    ids = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    idl = ids.long()
    net = torch.zeros(N, dtype=torch.int64, device=dev).index_add_(
        0, idl, ws.to(torch.int64))
    uniq_h = torch.full((N,), SENT, dtype=torch.int64, device=dev)
    uniq_h[idl] = hs
    uniq_l = torch.full((N,), SENT, dtype=torch.int64, device=dev)
    uniq_l[idl] = ls
    zeros = torch.zeros(N, dtype=torch.int32, device=dev)
    composite = live.pos[0].lo is not None
    qkey = (uniq_h, uniq_l) if composite else uniq_h
    if mesh is not None:
        exists = live.worker_shard(0).member(qkey, zeros)
        for k in range(1, mesh.local_workers):
            exists = exists | live.worker_shard(k).member(qkey, zeros)
        exists = any_worker(exists, mesh)
    else:
        exists = live.member(qkey, zeros)
    alive = uniq_h < SENT
    ins_m = alive & (net > 0) & ~exists
    del_m = alive & (net < 0) & exists

    def compact(mask):
        m = mask.to(torch.int32)
        cum = torch.cumsum(m, 0, dtype=torch.int32)
        pos = torch.where(mask, cum - 1, N)
        oh = torch.full((N,), SENT, dtype=torch.int64, device=dev)
        ol = torch.full((N,), SENT, dtype=torch.int64, device=dev)
        csr._scatter_drop(oh, pos, uniq_h)
        csr._scatter_drop(ol, pos, uniq_l)
        return oh, ol, m.sum(dtype=torch.int32)

    oih, oil, ni = compact(ins_m)
    odh, odl, nd = compact(del_m)
    return oih, oil, ni, odh, odl, nd


def _commit_fold(base: IndexData, cins: IndexData, cdel: IndexData,
                 uins: IndexData, udel: IndexData, *, cins_cap: int,
                 cdel_cap: int, sharded: bool = False):
    """The committed-region fold of one epoch, merged never rebuilt:

        cins' = (cins \\ udel) ∪ (uins \\ cdel)
        cdel' = cdel ∪ (udel ∩ base)

    One fold-kernel launch; ``base`` is only probed, for the delta-sized
    ``udel ∩ base`` bits, inside it.  ``sharded``: every region carries a
    leading [w] worker axis, and the one launch folds every shard (a
    delta entry and the committed entry it cancels share their owner)."""
    return commit_fold(cins, cdel, uins, udel, base=base, cins_cap=cins_cap,
                       cdel_cap=cdel_cap, sharded=sharded)


def _compact_fold(base: IndexData, cins: IndexData, cdel: IndexData, *,
                  out_cap: int, mesh=None) -> IndexData:
    """base' = (base \\ cdel) ∪ cins — the amortized O(|base|) merge
    (merge ranks through the rank kernel); with a ``mesh`` each of this
    rank's shards apart, stacked (three rank launches a shard)."""
    if mesh is not None:
        sv = csr.shard_view
        return csr.stack_shards(
            _compact_fold(sv(base, k), sv(cins, k), sv(cdel, k),
                          out_cap=out_cap)
            for k in range(mesh.local_workers))
    kept = csr._select_core(base, cdel, base.capacity, False)
    return csr._merge_core(kept, cins, out_cap)


def _any_member(idx: IndexData, qk, qv: torch.Tensor, mesh=None) -> bool:
    """any((qk, qv) ∈ idx) — the eager re-insertion probe (delta-sized),
    through the single-region membership kernel (with a ``mesh``, a call
    for each of this rank's shards and the OR over the ranks; one host
    read)."""
    qh, ql = qk if isinstance(qk, tuple) else (qk, None)
    if mesh is not None:
        hits = [member(d.key, d.val, d.n, qh, qv, los=d.lo, ql=ql).any()
                for d in (csr.shard_view(idx, k)
                          for k in range(mesh.local_workers))]
        return bool(any_worker(torch.stack(hits).any(), mesh))
    return bool(member(idx.key, idx.val, idx.n, qh, qv, los=idx.lo,
                       ql=ql).any())


def _packed_index(rows: np.ndarray, device, arity: int = 2,
                  capacity: Optional[int] = None,
                  shard_w: int = 0, workers=None) -> IndexData:
    """Packed full-row IndexData (key = the row's lex word pair — u<<32|v
    for edges, the wide (hi, lo) pair for arity 3-4 — val ≡ 0) from host
    rows, built at ``max(capacity, pow2(rows))``.  With ``shard_w`` it is
    hash-partitioned by ``csr.build_sharded_index`` (``capacity`` a
    per-shard floor; ``workers`` the shards kept): the projections'
    ownership code, so a live-set row and its projections' entries share
    their owner."""
    rows = np.asarray(rows, np.int32).reshape(-1, arity)
    rows_ext = np.concatenate(
        [rows, np.zeros((rows.shape[0], 1), np.int32)], axis=1)
    key_pos = tuple(range(arity))
    if shard_w:
        return csr.build_sharded_index(rows_ext, key_pos, arity, shard_w,
                                       capacity=capacity, narrow=False,
                                       device=device, workers=workers)
    return build_index(
        rows_ext, key_pos, arity,
        capacity=max(int(capacity or 0), _pow2(rows_ext.shape[0])),
        narrow=False, device=device)


def _empty_packed(device, arity: int = 2, shard_w: int = 0) -> IndexData:
    composite = arity > 2
    if not shard_w:
        return csr.empty_index(narrow=False, composite=composite,
                               device=device)
    w, SENT = int(shard_w), csr.SENTINEL
    return IndexData(
        torch.full((w, csr.SEG), SENT, dtype=torch.int64, device=device),
        torch.zeros((w, csr.SEG), dtype=torch.int32, device=device),
        torch.zeros(w, dtype=torch.int32, device=device),
        torch.full((w, csr.SEG), SENT, dtype=torch.int64, device=device)
        if composite else None)


def _pad_probe(keys, vals: np.ndarray, sent, device,
               cap: Optional[int] = None):
    """Pow2-pad a probe batch; ``keys`` is one packed array or a composite
    (hi, lo) pair (padding rows take the sentinel in every key word).
    ``cap`` raises the pad to a ratcheted rung."""
    if isinstance(keys, tuple):
        hi, lo = keys
        B = max(int(cap or 0), _pow2(hi.shape[0]))
        kh = np.full(B, csr.SENTINEL, np.int64)
        kl = np.full(B, csr.SENTINEL, np.int64)
        kh[:hi.shape[0]] = hi
        kl[:lo.shape[0]] = lo
        v = np.zeros(B, np.int32)
        v[:vals.shape[0]] = vals
        return ((torch.from_numpy(kh).to(device),
                 torch.from_numpy(kl).to(device)),
                torch.from_numpy(v).to(device))
    B = max(int(cap or 0), _pow2(keys.shape[0]))
    k = np.full(B, sent, keys.dtype)
    k[:keys.shape[0]] = keys
    v = np.zeros(B, np.int32)
    v[:vals.shape[0]] = vals
    return torch.from_numpy(k).to(device), torch.from_numpy(v).to(device)


@dataclasses.dataclass
class _Regions:
    """Device truth of one projection's regions (+ lazy host mirrors).

    With ``shard_w > 0`` every region tensor carries a leading [w] worker
    axis and each (key, val) entry is held by exactly one worker
    (``csr.build_sharded_index``); the counts are [w] vectors.

    On a mesh of ranks the tensors hold the rank's shards, ``[wl, cap]``,
    and the counts stay the whole mesh's [w] vectors.

    ``derived=True`` marks a projection whose (key, ext) columns do NOT
    cover the relation's full row (only for arity > 2, e.g. the a1->a3
    index of ``tri`` that ignores a2).  It is a lossy many-to-one image, so
    set folds cannot maintain it (deleting one supporting row must not kill
    a pair another live row still supports); ``versioned()`` derives it
    from the relation's live rows on demand, cached until the next
    begin_epoch/commit.  A delta plan seeded by the relation itself never
    reads one; a plan seeded by another relation can (the edge-seeded
    5-clique-quad plan reads quad's a3->a0 image), and then pays one host
    rebuild of the image per epoch."""

    key_pos: Tuple[int, ...]
    ext_pos: int
    rel: str = EDGE
    rel_arity: int = 0  # the backing relation's true arity
    shard_w: int = 0
    narrow: bool = True
    derived: bool = False
    d_base: IndexData = None
    d_cins: IndexData = None
    d_cdel: IndexData = None
    d_uins: IndexData = None
    d_udel: IndexData = None
    # exact live counts (host bookkeeping, pulled once per fold): ints for
    # one region, [w] int64 vectors sharded
    n_base: object = 0
    n_cins: object = 0
    n_cdel: object = 0
    _mirror: dict = dataclasses.field(default_factory=dict)
    _derived_cache: dict = dataclasses.field(default_factory=dict)
    _store: object = None

    @property
    def arity(self) -> int:
        return self.rel_arity or \
            max(max(self.key_pos, default=0), self.ext_pos) + 1

    @property
    def device(self):
        return self._store.device

    def _build(self, tup: np.ndarray, kind: str = "base") -> IndexData:
        rows = np.asarray(tup).reshape(-1, self.arity)
        store = self._store
        ratchet = store.base_ratchet if kind == "base" else store.ratchet
        key = (kind, self.rel)
        if self.shard_w:
            per = -(-max(rows.shape[0], 1) // self.shard_w)
            idx = csr.build_sharded_index(
                rows, self.key_pos, self.ext_pos, self.shard_w,
                capacity=ratchet.capacity(key, per), narrow=self.narrow,
                device=store.device, workers=store.mesh.span)
        else:
            cap = ratchet.capacity(key, rows.shape[0])
            idx = build_index(rows, self.key_pos, self.ext_pos, capacity=cap,
                              narrow=self.narrow, device=store.device)
        # a sharded build can pass the per-shard floor under skew: the
        # rung follows the capacity built
        ratchet.observe(key, idx.key.shape[-1])
        return idx

    def _rows(self, name: str) -> np.ndarray:
        if self.derived:
            # base = the backing relation's live rows; committed deltas fold
            # into the relation itself, never into this projection
            if name == "base":
                return self._store._rel_rows(self.rel)
            return np.zeros((0, self.arity), np.int32)
        if name not in self._mirror:
            self._mirror[name] = self._materialize(getattr(self,
                                                           "d_" + name))
            self._store.stats.mirror_pulls += 1
        return self._mirror[name]

    @property
    def base(self) -> np.ndarray:
        return self._rows("base")

    @property
    def cins(self) -> np.ndarray:
        return self._rows("cins")

    @property
    def cdel(self) -> np.ndarray:
        return self._rows("cdel")

    def _materialize(self, d: IndexData) -> np.ndarray:
        """Host tuple rows from the device (key[, lo], val) arrays (the
        shards' live rows in worker order), in canonical row-lex order."""
        key, val, lo = _live_parts(d, self._store.mesh)
        key = key.astype(np.int64)
        rows = np.zeros((key.shape[0], self.arity), np.int32)
        nk = len(self.key_pos)
        if lo is not None:
            key = (key, lo)
        kcols = csr.unpack_key(key, nk) if nk else None
        for c, p in enumerate(self.key_pos):
            rows[:, p] = kcols[:, c]
        rows[:, self.ext_pos] = val
        order = np.lexsort(tuple(rows[:, c]
                                 for c in range(rows.shape[1] - 1, -1, -1)))
        return rows[order]

    def set_uncommitted(self, uins: np.ndarray, udel: np.ndarray):
        if self.derived:
            self._derived_cache.clear()  # the "new" image changed
            return
        self.d_uins = self._build(uins, kind="delta")
        self.d_udel = self._build(udel, kind="delta")

    def probe_cdel(self, ins: np.ndarray) -> bool:
        """any(ins ∈ cdel) — device probe, O(|Δ|·log|cdel|)."""
        if self.derived:
            return False  # no committed-delete region to overlap
        key = csr.pack_key(tuple(ins[:, p].astype(np.int32)
                                 for p in self.key_pos))
        kdt = np.int32 if self.d_cdel.key.dtype == torch.int32 \
            else np.int64
        sent = csr.SENTINEL32 if kdt == np.int32 else csr.SENTINEL
        if not isinstance(key, tuple):
            key = key.astype(kdt)
        cap = self._store.ratchet.capacity(("probe", self.rel),
                                           ins.shape[0])
        qk, qv = _pad_probe(key, ins[:, self.ext_pos].astype(np.int32),
                            sent, self.device, cap=cap)
        return _any_member(self.d_cdel, qk, qv, self._store.mesh)

    def versioned(self, version: str) -> VersionedIndex:
        if self.derived:
            return self._derived_versioned(version)
        if version == "old":
            return VersionedIndex((self.d_base, self.d_cins), (self.d_cdel,))
        if version == "new":
            return VersionedIndex((self.d_base, self.d_cins, self.d_uins),
                                  (self.d_cdel, self.d_udel))
        if version == "static":
            return VersionedIndex((self.d_base,), ())
        raise ValueError(version)

    def _derived_versioned(self, version: str) -> VersionedIndex:
        """Projection image rebuilt from the relation's live rows: "old"
        (= "static") is the committed state, "new" folds the staged batch.
        Cached until the next begin_epoch/commit/compaction."""
        if version not in ("old", "new", "static"):
            raise ValueError(version)
        tag = "new" if version == "new" else "old"
        idx = self._derived_cache.get(tag)
        if idx is None:
            rows = self._store._rel_rows(self.rel)
            if tag == "new":
                ins, dels = self._store._staged_for(self.rel)
                if dels.size:
                    rows = rows[~rows_isin(rows, dels)]
                if ins.size:
                    rows = _unique_rows(np.concatenate([rows, ins]))
            idx = self._build(rows)
            self._derived_cache[tag] = idx
        return VersionedIndex((idx,), ())


def _live_parts(d: IndexData, mesh=None):
    """(key, val, lo or None) host arrays of a region's live entries; a
    sharded region's are its shards' in worker order, every rank's of
    ``mesh``."""
    if d.n.dim():
        parts = (d.key, d.val) + (() if d.lo is None else (d.lo,))
        _, got = gather_rows(d.n, parts, mesh)
        return got[0], got[1], None if d.lo is None else got[2]
    n = int(d.n)
    return (d.key[:n].cpu().numpy(), d.val[:n].cpu().numpy(),
            None if d.lo is None else d.lo[:n].cpu().numpy())


def _diff_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rows of a not in b (both [N, m] int)."""
    if a.size == 0 or b.size == 0:
        return a
    if a.shape[1] == 2:
        pa, pb = _pack2(a[:, 0], a[:, 1]), _pack2(b[:, 0], b[:, 1])
        return a[~np.isin(pa, pb)]
    return a[~rows_isin(a, b)]


@dataclasses.dataclass
class DeltaResult:
    count_delta: int
    tuples: Optional[np.ndarray]
    weights: Optional[np.ndarray]
    per_dq: List[JoinResult]


@dataclasses.dataclass
class StoreStats:
    """Per-store epoch accounting: one normalize and one commit per update
    epoch whatever the number of standing queries.  ``compile_events``
    counts the compile events (kernel libraries built or loaded,
    :mod:`~repro_torch.core.compilestats`) since the store was created;
    ``prewarm_compiles`` the part the admission prewarm spent.
    ``escalation_compiles`` keeps the JAX store's key (snapshots carry
    these stats) and stays 0: the port re-prewarms nothing after an
    escalation, its libraries being loaded already."""

    normalize_calls: int = 0
    commit_calls: int = 0
    compactions: int = 0
    epochs: int = 0
    live_compactions: int = 0
    composite_compactions: int = 0  # of the two above, (hi, lo) regions
    mirror_pulls: int = 0
    compile_events: int = 0
    prewarm_compiles: int = 0
    escalations: int = 0  # capacity rungs bumped after CapacityOverflow
    replays: int = 0  # epoch dataflow re-runs after an escalation
    rollbacks: int = 0  # rollback() calls
    escalation_compiles: int = 0  # the JAX store's key; 0 in the port


@dataclasses.dataclass
class PreparedBatch:
    """One update batch after :meth:`RegionStore.prepare`: validated,
    degenerate-masked, packed and sentinel-padded on the host."""

    rels: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]
    raw: Dict[str, Tuple[np.ndarray, np.ndarray]]
    was_dict: bool


@dataclasses.dataclass
class _RelLive:
    """One relation's live set: its own packed three-region LSM (key = the
    row's lex word pair, val ≡ 0)."""

    arity: int
    lb: IndexData = None
    lc_ins: IndexData = None
    lc_del: IndexData = None
    n_live: list = None  # [n_base, n_cins, n_cdel]
    mirror: Optional[np.ndarray] = None  # lazily-pulled host rows


class RegionStore:
    """Owner of every dynamic relation's live set and every projection's
    LSM regions, shared by every query registered against it: N standing
    queries pay one region build, one normalize and one commit per epoch.

    ``initial`` is an [E, 2] edge array (sugar for ``{"edge": edges}``) or
    a dict of relations of arity 2..4; updates arrive as per-relation
    batches (``{"edge": (rows, w), "tri": ...}``).  All state lives on
    ``device`` (``None``: the card, see ``csr.resolve_device``).

    ``shard_w > 0`` hash-partitions every device region over that many
    mesh workers (the distributed engine's layout, n-ary regions
    included): ownership is by the row's packed key, so the commit folds
    stay owner-local and no worker holds O(|R|) of a relation.  With a
    ``mesh`` of R ranks (a ``launch.mesh.WorkerMesh`` of ``shard_w``
    workers) this rank's store holds its workers' shards only; every
    rank must make the same calls with the same batches."""

    def __init__(self, initial, shard_w: int = 0,
                 compact_ratio: float = 0.5, device=None, mesh=None):
        self.device = csr.resolve_device(device)
        self.shard_w = int(shard_w)
        # the mesh of a sharded store (one process's when none is given):
        # this process holds the shards of its workers, ``mesh.span``
        if not self.shard_w:
            mesh = None
        elif mesh is None:
            mesh = make_host_mesh(self.shard_w, self.device)
        elif mesh.num_workers != self.shard_w:
            raise ValueError(f"a store of {shard_w} shards on a mesh of "
                             f"{mesh.num_workers} workers")
        self.mesh = mesh
        self.compact_ratio = compact_ratio
        self.projections: Dict[Projection, _Regions] = {}
        self.stats = StoreStats()
        self._compile_base = compilestats.total()
        # growth hysteresis: delta/probe/committed caps ride the slack
        # ladder and never shrink; base caps are monotone pow2
        self.ratchet = Ratchet()
        self.base_ratchet = Ratchet(factor=2)
        self._rels: Dict[str, _RelLive] = {}
        self._staged: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] \
            = None
        rels = initial if isinstance(initial, dict) else \
            {EDGE: np.asarray(initial, np.int32).reshape(-1, 2)}
        for rel, rows in rels.items():
            self.add_relation(rel, rows)

    def _sync_compile_stats(self):
        self.stats.compile_events = compilestats.total() - self._compile_base

    # ratcheted capacities: per-shard units when sharded
    def _per_shard(self, n: int) -> int:
        return -(-max(int(n), 1) // self.shard_w) if self.shard_w \
            else max(int(n), 1)

    def _packed(self, rows: np.ndarray, arity: int,
                capacity: Optional[int]) -> IndexData:
        """``_packed_index`` of host rows in this store's layout."""
        return _packed_index(rows, self.device, arity, capacity=capacity,
                             shard_w=self.shard_w,
                             workers=self.mesh and self.mesh.span)

    def _empty(self, arity: int) -> IndexData:
        return _empty_packed(self.device, arity,
                             self.mesh.local_workers if self.mesh else 0)

    def _base_cap(self, rel: str, n: int) -> int:
        return self.base_ratchet.capacity(("base", rel), self._per_shard(n))

    def _delta_cap(self, rel: str, n: int) -> int:
        return self.ratchet.capacity(("delta", rel), self._per_shard(n))

    def _probe_cap(self, rel: str, n: int) -> int:
        return self.ratchet.capacity(("probe", rel), max(int(n), 1))

    def _committed_cap(self, rel: str, n: int) -> int:
        return self.ratchet.capacity(("committed", rel), max(int(n), 1))

    def add_relation(self, rel: str, rows: np.ndarray,
                     arity: Optional[int] = None):
        """Register one dynamic relation with its initial tuples [N, arity]
        (arity 2..4; ``arity`` disambiguates an empty batch).

        Seeding a relation that exists but is still EMPTY (one
        ``register()`` declared before its tuples were materialized)
        replaces it in place — its projections are rebuilt from the seeded
        rows; a non-empty relation cannot be re-seeded."""
        old = self._rels.get(rel)
        if old is not None:
            staged = bool(self._staged) and rel in self._staged and \
                any(x.size for x in self._staged[rel])
            if self.num_tuples(rel) or staged:
                raise ValueError(f"relation {rel!r} already exists")
        rows = np.asarray(rows)
        if rows.ndim != 2 and not (rows.size == 0 and arity):
            raise ValueError(
                f"initial {rel!r} tuples must be [N, arity], got shape "
                f"{rows.shape}")
        ar = int(arity or rows.shape[1])
        if rows.ndim == 2 and rows.size and rows.shape[1] != ar:
            raise ValueError(
                f"initial {rel!r} tuples are [N, {rows.shape[1]}] but "
                f"arity={ar} was requested")
        if not 2 <= ar <= 4:
            raise ValueError(
                f"relation {rel!r} arity {ar} unsupported (2..4: composite "
                "keys cover up to 4 columns)")
        if old is not None and ar != old.arity:
            raise ValueError(
                f"relation {rel!r} was declared with arity {old.arity}, "
                f"cannot re-seed with arity {ar}")
        rows, _ = _check_batch(rel, rows.reshape(-1, ar), None, ar)
        rows = _unique_rows(rows)
        st = _RelLive(arity=ar)
        # the live set shards like the projections (ownership by packed
        # key), so a worker's live memory stays O(|R|/w)
        st.lb = self._packed(rows, ar, self._base_cap(rel, rows.shape[0]))
        self.base_ratchet.observe(("base", rel), st.lb.key.shape[-1])
        st.lc_ins = self._empty(ar)
        st.lc_del = self._empty(ar)
        zero = np.zeros(self.shard_w, np.int64) if self.shard_w else 0
        nb = _count_of(st.lb, self.mesh) if self.shard_w \
            else rows.shape[0]
        st.n_live = [nb, zero, zero]  # base, cins, cdel
        st.mirror = rows
        self._rels[rel] = st
        if old is not None:
            # rebuild projections ensured against the empty declaration
            for proj in [p for p in self.projections if p[0] == rel]:
                del self.projections[proj]
                self.ensure(*proj)

    # -- relation introspection ---------------------------------------------
    @property
    def relations(self) -> Tuple[str, ...]:
        return tuple(self._rels)

    def arity_of(self, rel: str) -> int:
        return self._rel(rel).arity

    def _rel(self, rel: str) -> _RelLive:
        st = self._rels.get(rel)
        if st is None:
            raise KeyError(
                f"unknown relation {rel!r}; known: "
                f"{', '.join(self._rels) or '(none)'} — pass it in the "
                "initial relations dict or add_relation() first")
        return st

    def _rel_rows(self, rel: str) -> np.ndarray:
        """The relation's live rows on the host (a lazily-materialized
        mirror: the warm epoch loop never touches it)."""
        st = self._rel(rel)
        if st.mirror is None:
            nb, nci, _ = st.n_live
            live = _compact_fold(
                st.lb, st.lc_ins, st.lc_del,
                out_cap=_pow2(_maxn(np.asarray(nb) + np.asarray(nci))),
                mesh=self.mesh)
            hi, _, lo = _live_parts(live, self.mesh)
            if lo is None:
                lo = np.zeros(hi.shape[0], np.int64)
            order = np.lexsort((lo, hi))
            st.mirror = _unpack_rows(hi[order], lo[order], st.arity)
            self.stats.mirror_pulls += 1
        return st.mirror

    def relation_rows(self, rel: str) -> np.ndarray:
        return self._rel_rows(rel)

    def num_tuples(self, rel: str) -> int:
        """Live tuple count, O(1) from tracked sizes."""
        nb, nci, ncd = self._rel(rel).n_live
        return _total(nb) + _total(nci) - _total(ncd)

    @property
    def max_live(self) -> int:
        return max((self.num_tuples(r) for r in self._rels), default=0)

    @property
    def edges(self) -> np.ndarray:
        return self._rel_rows(EDGE)

    @property
    def num_edges(self) -> int:
        return self.num_tuples(EDGE)

    def _live_index(self, rel: str) -> VersionedIndex:
        st = self._rel(rel)
        return VersionedIndex((st.lb, st.lc_ins), (st.lc_del,))

    def ensure(self, rel: str, key_pos: Tuple[int, ...], ext_pos: int,
               arity: Optional[int] = None) -> _Regions:
        """Region storage for one projection, built from the CURRENT live
        relation on first use and shared by every later query.  ``arity``
        lets a plan declare a not-yet-seen relation (created empty)."""
        st = self._rels.get(rel)
        if st is None:
            if arity is None:
                self._rel(rel)  # raises with the helpful message
            self.add_relation(rel, np.zeros((0, arity), np.int32))
            st = self._rels[rel]
        proj = (rel, key_pos, ext_pos)
        reg = self.projections.get(proj)
        if reg is not None:
            return reg
        # a projection whose key/ext columns don't cover the relation's
        # full row is a lossy image: DERIVED from the live rows on demand
        used = set(key_pos) | {ext_pos}
        covers = used == set(range(st.arity)) and \
            len(key_pos) + 1 == st.arity
        rows = self._rel_rows(rel)
        # narrow is decided ONCE per projection (merges keep one dtype);
        # composite projections with a single-column hi word (3 bound
        # columns) narrow too — the lo word is always int64
        narrow = csr.single_word_hi(len(key_pos)) and \
            (rows.size == 0 or int(rows.max()) < csr.SENTINEL32)
        reg = _Regions(key_pos, ext_pos, rel=rel, rel_arity=st.arity,
                       shard_w=self.shard_w, narrow=narrow,
                       derived=not covers, _store=self)
        if reg.derived:
            self.projections[proj] = reg
            return reg
        empty = rows[:0]
        reg.d_base = reg._build(rows)
        reg.d_cins = reg._build(empty, kind="committed")
        reg.d_cdel = reg._build(empty, kind="committed")
        reg.n_base = _count_of(reg.d_base, self.mesh) if self.shard_w \
            else rows.shape[0]
        reg.n_cins = reg.n_cdel = np.zeros(self.shard_w, np.int64) \
            if self.shard_w else 0
        reg._mirror.update(base=rows, cins=empty, cdel=empty)
        # a projection ensured mid-epoch must see the staged batch
        ins, dels = self._staged_for(rel)
        reg.set_uncommitted(ins, dels)
        self.projections[proj] = reg
        return reg

    def _staged_for(self, rel: str) -> Tuple[np.ndarray, np.ndarray]:
        empty = np.zeros((0, self._rel(rel).arity), np.int32)
        if not self._staged:
            return empty, empty
        return self._staged.get(rel, (empty, empty))

    def ensure_plan(self, plan: Plan):
        arities = {a.rel: a.arity for a in plan.query.atoms}
        for _id, rel, key_pos, ext_pos, _v in plan.index_ids():
            self.ensure(rel, key_pos, ext_pos, arity=arities.get(rel))
        # the seed relation may carry no index at all: declare it anyway so
        # seeds and updates for it resolve
        seed_rel = plan.query.atoms[plan.seed_atom].rel
        if seed_rel not in self._rels:
            self.add_relation(
                seed_rel, np.zeros((0, arities[seed_rel]), np.int32))

    def indices_for(self, plan: Plan) -> Indices:
        """The plan's VersionedIndex dict off the shared regions."""
        return {
            _id: self.ensure(rel, key_pos, ext_pos).versioned(version)
            for _id, rel, key_pos, ext_pos, version in plan.index_ids()}

    # -- admission prewarm ----------------------------------------------
    def pin_delta_marks(self, update_batch: int) -> int:
        """Pin every relation's probe and delta mark to the pow2 of the
        update-batch bound, as the JAX store's prewarm does, so delta-sized
        buffers keep one shape for the stream's life and the ratchet (which
        snapshots carry) equals the JAX session's.  Returns the pin."""
        P = _pow2(max(int(update_batch), 1))
        for rel in self._rels:
            self.ratchet.observe(("probe", rel), P)
            self.ratchet.observe(("delta", rel), P)
        return P

    def kernel_coverage(self, update_batch: int = 64) -> dict:
        """Per-relation kernel-launch evidence for the coverage gate.

        Runs, per relation, the exact calls a warm epoch makes and counts
        their CUDA launches (``kernels.LAUNCHES`` deltas): the commit fold
        over the relation's committed regions at the pinned delta capacity
        (the value :meth:`pin_delta_marks` pins, computed without pinning)
        and one OLD-version ``signed_member`` probe of its first
        non-derived projection.  The ``*_pallas_calls`` keys keep the JAX
        package's names and count the launches of the CUDA kernels that
        replace those Pallas calls (0 on the CPU, where the plain versions
        run).  Pure introspection: outputs are discarded, and no region,
        mark or ratchet changes.  A sharded store's fold is its worker
        axis's one launch, and its probe worker 0's shard's."""
        from repro_torch import kernels
        P = _pow2(max(int(update_batch), 1))
        sharded = bool(self.shard_w)
        out = {}
        for rel, st in self._rels.items():
            cc = int(st.lc_ins.key.shape[-1])  # current committed rung
            empty = self._packed(np.zeros((0, st.arity), np.int32),
                                 st.arity, P)
            before = sum(kernels.LAUNCHES.values())
            _commit_fold(st.lb, st.lc_ins, st.lc_del, empty, empty,
                         cins_cap=cc, cdel_cap=cc, sharded=sharded)
            fold_calls = sum(kernels.LAUNCHES.values()) - before
            probe_calls = 0
            for reg in self.projections.values():
                if reg.rel != rel or reg.derived:
                    continue
                vi = reg.versioned("old")
                if sharded:
                    vi = vi.worker_shard(0)
                composite = vi.pos[0].lo is not None
                z64 = torch.zeros(P, dtype=torch.int64, device=self.device)
                qk = (z64, z64) if composite else z64
                before = sum(kernels.LAUNCHES.values())
                vi.signed_member(qk, torch.zeros(P, dtype=torch.int32,
                                                 device=self.device))
                probe_calls = sum(kernels.LAUNCHES.values()) - before
                break
            out[rel] = {
                "composite": st.lb.lo is not None,
                "key_dtype": str(st.lb.key.dtype).replace("torch.", ""),
                "fold_pallas_calls": int(fold_calls),
                "fused_fold": bool(fold_calls == 1),
                "probe_pallas_calls": int(probe_calls),
            }
        return out

    # ------------------------------------------------------------------
    def prepare(self, updates, weights=None) -> PreparedBatch:
        """Stage A of an update epoch: validate, degenerate-mask, pack and
        sentinel-pad one batch on the host — pure numpy."""
        was_dict = isinstance(updates, dict)
        if was_dict:
            if weights is not None:
                raise ValueError(
                    "per-relation batches carry their own weights: pass "
                    "{rel: (rows, weights)}, not a top-level weights "
                    "argument")
            items = {rel: self._split(rel, batch)
                     for rel, batch in updates.items()}
        else:
            items = {EDGE: (updates, weights)}
        rels, raw = {}, {}
        for rel, (rows, w) in items.items():
            st = self._rel(rel)
            rows, w = _check_batch(rel, rows, w, st.arity)
            raw[rel] = (rows, w)
            rels[rel] = self._pad_host(rel, rows, w)
        return PreparedBatch(rels=rels, raw=raw, was_dict=was_dict)

    def normalize_prepared(self, prep: PreparedBatch) -> Dict:
        """Stage B: net the prepared batch against the live set on device.
        Returns ``{rel: (ins, dels)}``."""
        faults.fire("store.normalize")
        self.stats.normalize_calls += 1
        out = {rel: self._normalize_device(rel, *prep.rels[rel])
               for rel in prep.raw}
        self._sync_compile_stats()
        return out

    def normalize(self, updates, weights=None):
        """Net out a batch against the live set: ``(ins, dels)`` for an
        edge array, ``{rel: (ins, dels)}`` for the dict form."""
        prep = self.prepare(updates, weights)
        out = self.normalize_prepared(prep)
        return out if prep.was_dict else out[EDGE]

    def _split(self, rel: str, batch):
        if isinstance(batch, tuple):
            if len(batch) != 2:
                raise ValueError(
                    f"{rel!r} update entry must be rows or (rows, "
                    f"weights), got a {len(batch)}-tuple")
            return batch
        return batch, None

    def _pad_host(self, rel: str, updates: np.ndarray, weights: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host half of normalize: degenerate rows (any repeated vertex —
        the n-ary self-loop) and zero weights masked to the sentinel, rows
        packed to lex word pairs, all padded to the probe rung."""
        st = self._rel(rel)
        SENT = np.int64(csr.SENTINEL)
        valid = ~_degenerate_rows(updates) & (weights != 0)
        hi, lo = _pack_rows(updates, st.arity)
        hi = np.where(valid, hi, SENT)
        lo = np.where(valid, lo, SENT)
        B = self._probe_cap(rel, updates.shape[0])
        ph = np.full(B, SENT, np.int64)
        pl = np.full(B, SENT, np.int64)
        pw = np.zeros(B, np.int32)
        ph[:hi.shape[0]] = hi
        pl[:lo.shape[0]] = lo
        pw[:weights.shape[0]] = weights
        return ph, pl, pw

    def _normalize_rel(self, rel: str, updates, weights):
        st = self._rel(rel)
        updates, weights = _check_batch(rel, updates, weights, st.arity)
        return self._normalize_device(rel,
                                      *self._pad_host(rel, updates, weights))

    def _normalize_device(self, rel: str, ph: np.ndarray, pl: np.ndarray,
                          pw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        dev = self.device
        ar = self._rel(rel).arity
        oih, oil, ni, odh, odl, nd = _normalize_core(
            torch.from_numpy(ph).to(dev), torch.from_numpy(pl).to(dev),
            torch.from_numpy(pw).to(dev), self._live_index(rel), self.mesh)
        ni, nd = int(ni), int(nd)
        ins = _unpack_rows(oih[:ni].cpu().numpy(), oil[:ni].cpu().numpy(),
                           ar)
        dels = _unpack_rows(odh[:nd].cpu().numpy(), odl[:nd].cpu().numpy(),
                            ar)
        return ins, dels

    # ------------------------------------------------------------------
    def _maybe_compact(self, force: bool = False):
        # every test below reads the whole mesh's counts: all ranks
        # compact together
        w = self.shard_w
        zero = np.zeros(w, np.int64) if w else 0
        for rel, st in self._rels.items():
            nb, nci, ncd = st.n_live
            if (force or _total(nci) + _total(ncd) >
                    self.compact_ratio * max(_total(nb), 1)) and \
                    (_total(nci) or _total(ncd)):
                new_nb = np.asarray(nb) - np.asarray(ncd) + np.asarray(nci)
                out_cap = self.base_ratchet.capacity(("base", rel),
                                                     _maxn(new_nb))
                st.lb = _compact_fold(st.lb, st.lc_ins, st.lc_del,
                                      out_cap=out_cap, mesh=self.mesh)
                st.lc_ins = self._empty(st.arity)
                st.lc_del = self._empty(st.arity)
                st.n_live = [new_nb if w else int(new_nb), zero, zero]
                self.stats.live_compactions += 1
                self.stats.composite_compactions += st.lb.lo is not None
                st.mirror = None
                # the committed regions drained: restart their rung ladder
                self.ratchet.reset(("committed", rel))
                # cdel ⊆ base and cins ∩ base = ∅ make the compacted size
                # exact arithmetic — a mismatch means corruption
                got = _count_of(st.lb, self.mesh)
                assert (np.asarray(got) == new_nb).all()
        for reg in self.projections.values():
            if reg.derived:
                continue  # rebuilt from the relation rows on demand
            committed = _total(reg.n_cins) + _total(reg.n_cdel)
            if not (force or committed >
                    self.compact_ratio * max(_total(reg.n_base), 1)):
                continue
            if committed:
                new_n = np.asarray(reg.n_base) - np.asarray(reg.n_cdel) \
                    + np.asarray(reg.n_cins)
                out_cap = self.base_ratchet.capacity(("base", reg.rel),
                                                     _maxn(new_n))
                reg.d_base = _compact_fold(reg.d_base, reg.d_cins,
                                           reg.d_cdel, out_cap=out_cap,
                                           mesh=self.mesh)
                got = _count_of(reg.d_base, self.mesh)
                assert (np.asarray(got) == new_n).all()
                reg.n_base = got
                self.ratchet.reset(("committed", reg.rel))
                empty = np.zeros((0, reg.arity), np.int32)
                reg.d_cins = reg._build(empty, kind="committed")
                reg.d_cdel = reg._build(empty, kind="committed")
                reg.n_cins = zero
                reg.n_cdel = zero
                self.stats.compactions += 1
                self.stats.composite_compactions += reg.d_base.lo is not None
                reg._mirror.clear()

    def _as_batches(self, ins, dels=None) -> Dict:
        """Array sugar -> per-relation {rel: (ins, dels)} batches."""
        if isinstance(ins, dict):
            out = {}
            if dels is None:
                for rel, (ri, rd) in ins.items():
                    ar = self._rel(rel).arity
                    out[rel] = (np.asarray(ri, np.int32).reshape(-1, ar),
                                np.asarray(rd, np.int32).reshape(-1, ar))
                return out
            if not isinstance(dels, dict):
                raise ValueError("mixed dict/array (ins, dels) batches")
            for rel in set(ins) | set(dels):
                ar = self._rel(rel).arity
                empty = np.zeros((0, ar), np.int32)
                out[rel] = (np.asarray(ins.get(rel, empty),
                                       np.int32).reshape(-1, ar),
                            np.asarray(dels.get(rel, empty),
                                       np.int32).reshape(-1, ar))
            return out
        return {EDGE: (np.asarray(ins, np.int32).reshape(-1, 2),
                       np.asarray(dels, np.int32).reshape(-1, 2))}

    def begin_epoch(self, ins, dels=None):
        """Stage one normalized batch (edge-array sugar or per-relation
        dicts) as the uncommitted region of EVERY projection (after the
        eager re-insertion compaction check)."""
        batches = self._as_batches(ins, dels)
        # eager compaction iff a committed delete is being re-inserted
        need = False
        for rel, (r_ins, r_dels) in batches.items():
            if not r_ins.size:
                continue
            st = self._rel(rel)
            if _total(st.n_live[2]):
                pi = _pack_rows(r_ins, st.arity)
                qk, qv = _pad_probe(pi if st.arity > 2 else pi[0],
                                    np.zeros(r_ins.shape[0], np.int32),
                                    np.int64(csr.SENTINEL), self.device,
                                    cap=self._probe_cap(rel,
                                                        r_ins.shape[0]))
                need = need or _any_member(st.lc_del, qk, qv, self.mesh)
            if not need:
                need = any(reg.probe_cdel(r_ins)
                           for reg in self.projections.values()
                           if reg.rel == rel and not reg.derived
                           and _total(reg.n_cdel))
            # every rank holds the same batch: a global test
            if int(r_ins.max()) >= csr.SENTINEL32 and \
                    any(reg.narrow for reg in self.projections.values()
                        if reg.rel == rel):
                raise ValueError(
                    f"vertex id >= {csr.SENTINEL32} collides with the "
                    "narrow int32 index sentinel of an existing "
                    f"{rel!r} projection; ids this large must be present "
                    "in the initial tuples so the projection is built "
                    "wide")
        self._maybe_compact(force=bool(need))
        self._staged = batches
        for reg in self.projections.values():
            reg.set_uncommitted(*self._staged_for(reg.rel))

    def commit(self, ins, dels=None):
        """Fold uins/udel into the committed regions (with cancellation)
        and advance the live set — once per epoch, shared by every query.

        Stage-then-swap: every fold output is computed first and the store
        is mutated only after all folds succeeded, so a failure (an
        injected ``store.commit.fold`` fault) leaves it at the epoch
        boundary for :meth:`rollback`; the swap has no fault point."""
        if self._staged is None:
            # raw commit without begin_epoch: net the args first
            raw = self._as_batches(ins, dels)
            self.stats.normalize_calls += 1
            netted = {
                rel: self._normalize_rel(
                    rel, np.concatenate([ri, rd]),
                    np.concatenate([np.ones(ri.shape[0], np.int32),
                                    -np.ones(rd.shape[0], np.int32)]))
                for rel, (ri, rd) in raw.items()}
            self.begin_epoch(netted)
        batches = self._staged
        w, sharded = self.shard_w, bool(self.shard_w)
        # ---- stage: compute every fold output, store untouched ------------
        # (the folds allocate their outputs, never write their inputs, so
        # a fault mid-commit leaves the old committed regions whole)
        staged_rels = []  # (st, new_cins, new_cdel, n_live)
        for rel, (r_ins, r_dels) in batches.items():
            if not (r_ins.size or r_dels.size):
                continue
            st = self._rel(rel)
            faults.fire("store.commit.fold")
            li = self._packed(r_ins, st.arity,
                              self._delta_cap(rel, r_ins.shape[0]))
            self.ratchet.observe(("delta", rel), li.key.shape[-1])
            ld = self._packed(r_dels, st.arity,
                              self._delta_cap(rel, r_dels.shape[0]))
            self.ratchet.observe(("delta", rel), ld.key.shape[-1])
            nb, nci, ncd = st.n_live
            need = max(
                _maxn(np.asarray(nci) + np.asarray(_count_of(li, self.mesh))),
                _maxn(np.asarray(ncd) + np.asarray(_count_of(ld, self.mesh))))
            cc = self._committed_cap(rel, need)
            new_ci, new_cd = _commit_fold(st.lb, st.lc_ins, st.lc_del, li,
                                          ld, cins_cap=cc, cdel_cap=cc,
                                          sharded=sharded)
            staged_rels.append((st, new_ci, new_cd,
                                [nb, _count_of(new_ci, self.mesh),
                                 _count_of(new_cd, self.mesh)]))
        staged_projs = []  # (reg, d_cins, d_cdel, empty_ins, empty_dels)
        derived_dirty = []
        for reg in self.projections.values():
            r_ins, r_dels = batches.get(
                reg.rel, (np.zeros((0, reg.arity), np.int32),) * 2)
            if reg.derived:
                if r_ins.size or r_dels.size:
                    derived_dirty.append(reg)  # committed rows changed
                continue
            if not (r_ins.size or r_dels.size):
                continue  # untouched relation: regions pass through
            faults.fire("store.commit.fold")
            need = max(
                _maxn(np.asarray(reg.n_cins)
                      + np.asarray(_count_of(reg.d_uins, self.mesh))),
                _maxn(np.asarray(reg.n_cdel)
                      + np.asarray(_count_of(reg.d_udel, self.mesh))))
            cc = self._committed_cap(reg.rel, need)
            d_cins, d_cdel = _commit_fold(
                reg.d_base, reg.d_cins, reg.d_cdel, reg.d_uins, reg.d_udel,
                cins_cap=cc, cdel_cap=cc, sharded=sharded)
            staged_projs.append((reg, d_cins, d_cdel, r_ins[:0],
                                 r_dels[:0]))
        # ---- swap: pure host assignments, no fault points -----------------
        self._staged = None
        for st, new_ci, new_cd, n_live in staged_rels:
            st.lc_ins, st.lc_del = new_ci, new_cd
            st.n_live = n_live
            st.mirror = None
        for reg in derived_dirty:
            reg._derived_cache.clear()
        for reg, d_cins, d_cdel, e_ins, e_dels in staged_projs:
            reg.d_cins, reg.d_cdel = d_cins, d_cdel
            reg.n_cins = _count_of(d_cins, self.mesh)
            reg.n_cdel = _count_of(d_cdel, self.mesh)
            reg.set_uncommitted(e_ins, e_dels)
            reg._mirror.pop("cins", None)
            reg._mirror.pop("cdel", None)
        self.stats.commit_calls += 1
        self.stats.epochs += 1
        self._maybe_compact()
        self._sync_compile_stats()

    def rollback(self) -> None:
        """Return the store to the epoch boundary: drop the staged batch
        and reset every projection's uncommitted region to empty.  Exact
        because :meth:`commit` swaps nothing in until every fold is done."""
        self._staged = None
        for reg in self.projections.values():
            empty = np.zeros((0, reg.arity), np.int32)
            reg.set_uncommitted(empty, empty)
        self.stats.rollbacks += 1

    # -- durability: the JAX store's snapshot format ----------------------
    SNAPSHOT_FORMAT = 1

    def device_bytes(self) -> int:
        """Bytes of every device region this process holds (the live
        sets' and the non-derived projections')."""
        idx = [r for st in self._rels.values()
               for r in (st.lb, st.lc_ins, st.lc_del)]
        idx += [getattr(reg, "d_" + nm) for reg in self.projections.values()
                if not reg.derived
                for nm in ("base", "cins", "cdel", "uins", "udel")]
        return sum(t.nbytes for d in idx if d is not None
                   for _, t in self._index_parts(d))

    @staticmethod
    def _index_parts(idx: IndexData):
        parts = [("key", idx.key), ("val", idx.val), ("n", idx.n)]
        if idx.lo is not None:
            parts.append(("lo", idx.lo))
        return parts

    def _ranked(self) -> bool:
        return self.mesh is not None and self.mesh.ranks > 1

    def snapshot(self, extra: Optional[dict] = None
                 ) -> Optional[Tuple[List[np.ndarray], dict]]:
        """The store's state as ``(leaves, meta)``: host numpy leaves in
        ``meta["names"]`` order and a JSON-safe ``meta``, leaf for leaf and
        key for key the JAX store's ``snapshot()``, so either package
        restores the other's.  A sharded store's leaves keep their leading
        [w] worker axis and its counts are [w] lists.  ``extra`` entries
        are added to ``meta`` (the session's, under ``"session"``).

        Per relation (sorted): the live set's three regions
        ``rel/<rel>/{lb,lc_ins,lc_del}.{key,val,n[,lo]}`` and its counts;
        per non-derived projection (sorted by ``repr`` of its key):
        ``proj/<i>/{d_base,d_cins,d_cdel}.*`` and its counts; both ratchets'
        marks and the epoch counters.  Only at an epoch boundary: the
        staged batch is transient.

        On a mesh of R ranks this is a collective that every rank calls:
        a digest of each rank's ``meta`` is gathered first (every host
        decision reads the whole mesh, so they must agree; a disagreement
        raises :class:`SnapshotError` on every rank), then each leaf's
        [wl] rows are gathered to rank 0 one leaf at a time, so that rank
        0's card holds at most one whole leaf.  Rank 0 returns the
        one-process format, the same names, ``meta`` and [w] leaves; the
        other ranks return ``None``."""
        if self._staged is not None:
            raise SnapshotError(
                "snapshot mid-epoch: commit (or rollback) the staged batch "
                "first — snapshots are epoch-boundary consistent")
        tensors: List[torch.Tensor] = []
        names: List[str] = []

        def emit(prefix, idx):
            for suffix, t in self._index_parts(idx):
                names.append(f"{prefix}.{suffix}")
                tensors.append(t)

        meta_rels = {}
        for rel in sorted(self._rels):
            st = self._rels[rel]
            for region, idx in (("lb", st.lb), ("lc_ins", st.lc_ins),
                                ("lc_del", st.lc_del)):
                emit(f"rel/{rel}/{region}", idx)
            meta_rels[rel] = {"arity": st.arity,
                              "n_live": [np.asarray(n).tolist()
                                         for n in st.n_live]}
        projs = []
        for i, (_, reg) in enumerate(
                sorted(self.projections.items(), key=lambda kv: repr(kv[0]))):
            spec = {"rel": reg.rel, "key_pos": list(reg.key_pos),
                    "ext_pos": int(reg.ext_pos),
                    "rel_arity": int(reg.rel_arity),
                    "narrow": bool(reg.narrow),
                    "derived": bool(reg.derived)}
            if not reg.derived:
                for region in ("d_base", "d_cins", "d_cdel"):
                    emit(f"proj/{i}/{region}", getattr(reg, region))
                spec["n_base"] = np.asarray(reg.n_base).tolist()
                spec["n_cins"] = np.asarray(reg.n_cins).tolist()
                spec["n_cdel"] = np.asarray(reg.n_cdel).tolist()
            projs.append(spec)

        def marks(ratchet):
            return [[list(k), v] for k, v in
                    sorted(ratchet.marks().items(),
                           key=lambda kv: repr(kv[0]))]

        meta = {
            "format": self.SNAPSHOT_FORMAT,
            "shard_w": int(self.shard_w),
            "compact_ratio": float(self.compact_ratio),
            "rels": meta_rels,
            "projections": projs,
            "ratchet": marks(self.ratchet),
            "base_ratchet": marks(self.base_ratchet),
            "stats": {f: getattr(self.stats, f) for f in
                      ("normalize_calls", "commit_calls", "compactions",
                       "epochs", "live_compactions")},
            "names": names,
        }
        meta.update(extra or {})
        if self._ranked():
            digest = int.from_bytes(hashlib.sha256(json.dumps(
                meta, sort_keys=True).encode()).digest()[:8], "little",
                signed=True)
            got = per_rank(digest, self.mesh)
            if len(set(got)) != 1:
                raise SnapshotError(
                    f"the ranks' snapshot metas differ (digests {got}): "
                    "their host state diverged")
        # a copy even on the host: the leaves share no memory with the
        # store's tensors
        leaves = []
        for t in tensors:
            whole = gather_to_root(t, self.mesh) if self.shard_w else t
            if whole is not None:
                leaves.append(whole.to("cpu", copy=True).numpy())
            del whole
        if self._ranked() and self.mesh.rank != 0:
            return None
        return leaves, meta

    def share_snapshot(self, leaves: Optional[List[np.ndarray]],
                       meta: Optional[dict], check=None
                       ) -> Tuple[dict, list]:
        """Check a snapshot against this store (after ``check(meta)``, the
        caller's own check, which raises ``ValueError``) and return its
        ``meta`` and each leaf's (shape, dtype str) on every rank: rank
        0's arguments, broadcast on a mesh of ranks (the other ranks' are
        ignored, and every rank raises what rank 0 found wrong), the
        arguments themselves in one process."""
        err, shapes = None, None
        if not self._ranked() or self.mesh.rank == 0:
            try:
                if check is not None:
                    check(meta)
                names = meta.get("names", [])
                if meta.get("format") != self.SNAPSHOT_FORMAT:
                    raise ValueError(f"unknown snapshot format "
                                     f"{meta.get('format')!r}")
                if int(meta["shard_w"]) != int(self.shard_w):
                    raise ValueError(
                        f"snapshot was taken on a shard_w={meta['shard_w']}"
                        f" store; this store has shard_w={self.shard_w} — "
                        "restore onto the same mesh width")
                if len(leaves) != len(names) or \
                        len(set(names)) != len(names):
                    raise ValueError(
                        "snapshot leaves do not match meta['names']")
                shapes = [(tuple(np.shape(a)), np.asarray(a).dtype.str)
                          for a in leaves]
            except ValueError as exc:
                err = str(exc)
        if self._ranked():
            err, meta, shapes = broadcast_object((err, meta, shapes),
                                                 self.mesh)
        if err is not None:
            raise ValueError(err)
        return meta, shapes

    def restore(self, leaves: Optional[List[np.ndarray]],
                meta: Optional[dict], shapes: Optional[list] = None
                ) -> None:
        """Replace this store's state by a :meth:`snapshot` (of either
        package), in place, every tensor on ``self.device``.  Engines
        resolve their regions through :meth:`indices_for` each run, so
        they read the restored state without a rebuild.  A snapshot of
        another format or mesh width raises before anything changes.

        On a mesh of R ranks this is a collective that every rank calls,
        and only rank 0's ``leaves`` and ``meta`` are read (the other
        ranks pass ``None``): ``meta`` is broadcast
        (:meth:`share_snapshot`; a caller that already shared it passes
        its ``meta`` and the ``shapes`` it returned), then each leaf's
        [w] rows are scattered, each rank keeping its workers' span, so a
        snapshot taken at any R restores at any other."""
        if shapes is None:
            meta, shapes = self.share_snapshot(leaves, meta)
        root = not self._ranked() or self.mesh.rank == 0
        at = {name: i for i, name in enumerate(meta["names"])}
        dev = self.device

        def leaf(name) -> torch.Tensor:
            i = at[name]
            host = leaves[i] if root else None
            if not self.shard_w:
                return torch.tensor(np.asarray(host), device=dev)
            shape, dt = shapes[i]
            return scatter_from_root(
                host, shape, torch.from_numpy(np.zeros(0, dt)).dtype,
                self.mesh)

        def pull(prefix) -> IndexData:
            return IndexData(
                *(leaf(f"{prefix}.{part}") for part in ("key", "val", "n")),
                leaf(f"{prefix}.lo") if f"{prefix}.lo" in at else None)

        def nval(v):
            arr = np.asarray(v, np.int64)
            return arr if self.shard_w else int(arr)

        # ratchet marks first (JSON lists back to tuple keys): the empty
        # uncommitted regions built below land on the snapshot's rungs
        for ratchet, recs in ((self.ratchet, meta["ratchet"]),
                              (self.base_ratchet, meta["base_ratchet"])):
            ratchet.reset()
            for key, cap in recs:
                ratchet.observe(tuple(key), int(cap))
        self._staged = None
        self._rels = {}
        for rel, rec in meta["rels"].items():
            st = _RelLive(arity=int(rec["arity"]))
            st.lb = pull(f"rel/{rel}/lb")
            st.lc_ins = pull(f"rel/{rel}/lc_ins")
            st.lc_del = pull(f"rel/{rel}/lc_del")
            st.n_live = [nval(n) for n in rec["n_live"]]
            self._rels[rel] = st
        self.projections = {}
        for i, spec in enumerate(meta["projections"]):
            reg = _Regions(tuple(spec["key_pos"]), int(spec["ext_pos"]),
                           rel=spec["rel"], rel_arity=int(spec["rel_arity"]),
                           shard_w=self.shard_w, narrow=bool(spec["narrow"]),
                           derived=bool(spec["derived"]), _store=self)
            if not reg.derived:
                reg.d_base = pull(f"proj/{i}/d_base")
                reg.d_cins = pull(f"proj/{i}/d_cins")
                reg.d_cdel = pull(f"proj/{i}/d_cdel")
                reg.n_base = nval(spec["n_base"])
                reg.n_cins = nval(spec["n_cins"])
                reg.n_cdel = nval(spec["n_cdel"])
                empty = np.zeros((0, reg.arity), np.int32)
                reg.set_uncommitted(empty, empty)
            self.projections[(spec["rel"], tuple(spec["key_pos"]),
                              int(spec["ext_pos"]))] = reg
        for f, v in meta["stats"].items():
            setattr(self.stats, f, int(v))
        self._sync_compile_stats()


class DeltaBigJoin:
    """Incremental maintenance of one query over dynamic relations (each
    dQ_i seeds from the batch of ITS atom's relation, n-ary dR tuples at
    P_r, ``plan.seed_width``); rides a shared :class:`RegionStore`
    (``store=``) or owns a private one built from ``initial_edges`` (an
    edge array or a dict of relations)."""

    MAX_ESCALATIONS = 3  # per plan run, before the overflow surfaces
    # the kernel libraries an epoch launches: normalize and the
    # re-insertion probe (membership), the level steps (fused extend),
    # the commit (fold) and compactions (merge ranks)
    LIBRARIES = ("intersect", "extend", "fold", "merge_rank")

    def __init__(self, query: Query, initial_edges,
                 cfg: BigJoinConfig = BigJoinConfig(mode="collect"),
                 compact_ratio: float = 0.5,
                 store: Optional[RegionStore] = None, device=None):
        self.query = query
        self.cfg = cfg
        self.plans: List[Plan] = [make_delta_plan(dq)
                                  for dq in delta_queries(query)]
        if store is None:
            store = self._new_store(initial_edges, compact_ratio, device)
        self.store = store
        for plan in self.plans:
            self.store.ensure_plan(plan)

    def _new_store(self, edges, compact_ratio: float, device) -> RegionStore:
        """The engine's private store; the mesh engine overrides it to
        build worker-sharded regions."""
        return RegionStore(edges, compact_ratio=compact_ratio, device=device)

    def prewarm(self, update_batch: int,
                horizon: Optional[int] = None) -> int:
        """The admission prewarm of this engine: pin the store's probe and
        delta marks to ``update_batch`` (as the JAX engine's walk does) and,
        on the card, load every kernel library its epochs launch, so the
        first served epoch builds nothing.  Eager PyTorch compiles nothing
        per shape, so the JAX walk over rung combinations has no
        counterpart yet and ``horizon`` (the JAX signature's) is unused;
        nor does an escalation re-prewarm, since the libraries stay loaded.
        Returns the compile events spent."""
        from repro_torch.kernels import _build
        snap = compilestats.snapshot()
        self.store.pin_delta_marks(update_batch)
        if self.store.device.type == "cuda":
            for name in self.LIBRARIES:
                _build.lib(name)
        return compilestats.since(snap)

    def _run_plan(self, plan: Plan, indices: Indices, seed: np.ndarray,
                  weights: np.ndarray) -> JoinResult:
        return run_bigjoin(plan, indices, seed, weights, cfg=self.cfg,
                           device=self.store.device)

    def _escalate(self, exc: CapacityOverflow) -> None:
        """Bump the offending capacity rung(s) on the store ratchet and
        rebuild this engine's config; re-raises when the overflow names no
        buffer this engine can grow."""
        qn = self.query.name
        r = self.store.ratchet
        cfg, changed = self.cfg, False
        if exc.kinds & ESCALATES_OUT:
            new_out = r.escalate(("cap", "out", qn),
                                 floor=cfg.out_capacity)
            cfg = dataclasses.replace(cfg, out_capacity=new_out)
            changed = True
        if exc.kinds & ESCALATES_BATCH:
            new_b = r.escalate(("cap", "batch", qn), floor=cfg.batch)
            cfg = dataclasses.replace(
                cfg, batch=new_b, seed_chunk=max(cfg.seed_chunk, new_b))
            changed = True
        if not changed:
            raise exc
        self.cfg = cfg
        self.store.stats.escalations += 1

    def _run_plan_escalating(self, plan: Plan, seed: np.ndarray,
                             weights: np.ndarray) -> JoinResult:
        """One plan run with escalate-and-replay: the store is read-only
        during the run, so a replay after a rung bump is exact."""
        for attempt in range(self.MAX_ESCALATIONS + 1):
            try:
                return self._run_plan(plan, self.store.indices_for(plan),
                                      seed, weights)
            except CapacityOverflow as exc:
                if attempt >= self.MAX_ESCALATIONS:
                    raise
                self._escalate(exc)
                self.store.stats.replays += 1
        raise AssertionError("unreachable")

    def run_delta_plans(self, ins, dels=None) -> DeltaResult:
        """Evaluate dAQ_1..dAQ_n for one staged batch (the store must have
        ``begin_epoch``-ed it); does NOT commit."""
        batches = self.store._as_batches(ins, dels)
        per_dq: List[JoinResult] = []
        total = 0
        tuples, wts = [], []
        for plan in self.plans:
            rel = plan.query.atoms[plan.seed_atom].rel
            r_ins, r_dels = batches.get(
                rel, (np.zeros((0, 2), np.int32),) * 2)
            if r_ins.size == 0 and r_dels.size == 0:
                continue  # this relation did not change: dQ_i is empty
            delta_rows = np.concatenate([r_ins, r_dels], axis=0)
            delta_w = np.concatenate([
                np.ones(r_ins.shape[0], np.int32),
                -np.ones(r_dels.shape[0], np.int32)])
            seed = delta_rows[:, list(plan.seed_cols)]
            res = self._run_plan_escalating(plan, seed, delta_w)
            per_dq.append(res)
            total += res.count
            if res.tuples is not None and res.tuples.size:
                tuples.append(res.tuples)
                wts.append(res.weights)
        out_t = np.concatenate(tuples) if tuples else None
        out_w = np.concatenate(wts) if wts else None
        return DeltaResult(total, out_t, out_w, per_dq)

    def apply(self, updates, weights=None) -> DeltaResult:
        """Process one update batch: emit output changes, then commit."""
        batches = self.store.normalize(updates, weights)
        if not isinstance(batches, dict):
            batches = {EDGE: batches}
        if all(i.size == 0 and d.size == 0 for i, d in batches.values()):
            return DeltaResult(0, None, None, [])
        self.store.begin_epoch(batches)
        result = self.run_delta_plans(batches)
        self.store.commit(batches)
        return result


def _row_codes(*arrays):
    """Order-preserving int64 codes of [N, m] non-negative integer rows
    (column 0 most significant), or None when the ids need more than
    62 bits in all."""
    m = arrays[0].shape[1]
    top = max((int(a.max()) for a in arrays if a.size), default=0)
    bits = max(top.bit_length(), 1)
    if bits * m > 62:
        return None
    out = []
    for a in arrays:
        code = np.zeros(a.shape[0], np.int64)
        for c in range(m):
            code = (code << bits) | a[:, c].astype(np.int64)
        out.append(code)
    return out


def _unique_rows(a: np.ndarray) -> np.ndarray:
    """``np.unique(a, axis=0)`` (lexicographic distinct rows)."""
    codes = _row_codes(a) if a.size else None
    if codes is None:
        return np.unique(a, axis=0)
    _, first = np.unique(codes[0], return_index=True)
    return a[first]


def rows_isin(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-membership mask of ``a``'s rows in ``b`` (both [N, m] int)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros(a.shape[0], bool)
    codes = _row_codes(a, b)
    if codes is not None:
        return np.isin(codes[0], codes[1])
    both = np.concatenate([a, b], axis=0)
    _, inv = np.unique(both, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    return np.isin(inv[:a.shape[0]], inv[a.shape[0]:])


def canon_arrays(tuples: Optional[np.ndarray], weights: Optional[np.ndarray],
                 num_attrs: int) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`canon_signed` as arrays: the distinct rows [N, m] in
    lexicographic order with their net weight, rows netting to zero
    dropped."""
    if tuples is None or tuples.size == 0:
        return np.zeros((0, num_attrs), np.int32), np.zeros(0, np.int64)
    codes = _row_codes(tuples)
    if codes is None:
        uniq, inv = np.unique(tuples, axis=0, return_inverse=True)
    else:
        _, first, inv = np.unique(codes[0], return_index=True,
                                  return_inverse=True)
        uniq = tuples[first]
    net = np.zeros(uniq.shape[0], np.int64)
    np.add.at(net, inv.reshape(-1), weights)
    keep = net != 0
    return uniq[keep].astype(np.int32), net[keep]


def canon_signed(tuples: Optional[np.ndarray],
                 weights: Optional[np.ndarray]) -> list:
    """Canonical form of a signed tuple multiset: sorted (tuple, net
    weight != 0) pairs — the comparison key of every differential."""
    if tuples is None or tuples.size == 0:
        return []
    rows, net = canon_arrays(tuples, weights, tuples.shape[1])
    return [(tuple(r), int(n)) for r, n in zip(rows, net)]


def delta_oracle(query: Query, edges_before, edges_after
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Ground truth: signed difference of full recomputation by the serial
    Generic Join.  Returns (tuples [N, m] int32, weights [N] ±1), added
    rows first, each block in lexicographic row order."""
    from repro_torch.core.generic_join import generic_join
    before = edges_before if isinstance(edges_before, dict) \
        else {EDGE: edges_before}
    after = edges_after if isinstance(edges_after, dict) \
        else {EDGE: edges_after}
    a, _ = generic_join(query, before)
    b, _ = generic_join(query, after)
    m = query.num_attrs
    a = _unique_rows(np.asarray(a, np.int32).reshape(-1, m))
    b = _unique_rows(np.asarray(b, np.int32).reshape(-1, m))
    added = b[~rows_isin(b, a)]
    removed = a[~rows_isin(a, b)]
    t = np.concatenate([added, removed]).astype(np.int32).reshape(-1, m)
    w = np.concatenate([np.ones(added.shape[0], np.int32),
                        -np.ones(removed.shape[0], np.int32)])
    return t, w
