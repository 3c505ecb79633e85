"""Sorted-array extension indices (the ``Ext`` of §2.2) as torch tensors.

Each index is a *sorted dual array*: a packed key column (the bound prefix)
and an int32 value column (the extension), sorted lexicographically and
sentinel-padded to a capacity that is a multiple of ``SEG``.  Counts and
slices come from two ``searchsorted`` probes over the key; membership is a
fixed-depth lexicographic binary search over the (key, val) pairs.

The layout, capacities and padding equal the JAX package's bit for bit, so
regions can be carried across (``repro_torch.convert``) and compared.  The
live count ``n`` is a 0-d int32 tensor on the index's device, so searches
never synchronise with the host.  Keys of 3 or 4 bound columns (n-ary
relations) are the composite (hi, lo) word pair: ``key`` holds the hi word
and ``lo`` the int64 lo word, and every probe compares (key, lo[, val])
lexicographically.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

# Sentinel keys strictly larger than any real key: int64-max for wide keys
# (two packed int32 columns), int32-max for narrow single-column keys.
SENTINEL = int(np.iinfo(np.int64).max)
SENTINEL32 = int(2**31 - 1)

# Capacity quantum (the JAX kernels' segment length); capacities are
# rounded up to SEG multiples so shapes match the reference exactly.
SEG = 128


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: ``None`` means the card and raises
    when CUDA is absent; the plain versions run on the host only when the
    caller asks for ``"cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on the card by default and CUDA is not "
                "available; pass device='cpu' to run the plain versions on "
                "the host")
        device = "cuda"
    return torch.device(device)


def round_capacity(cap: int) -> int:
    return -(-max(int(cap), 1) // SEG) * SEG


def pow2_capacity(n: int) -> int:
    """SEG-aligned power-of-two capacity >= n (stable shapes across deltas)."""
    return round_capacity(1 << max(int(n) - 1, 0).bit_length())


def capacity_ladder(lo: int, hi: int) -> list:
    """All :func:`pow2_capacity` rungs covering live sizes in [lo, hi]:
    the capacities a buffer can take while its live size stays in the
    range (``pow2_capacity`` maps any size in (rung/2, rung] to rung)."""
    lo_cap, hi_cap = pow2_capacity(lo), pow2_capacity(max(hi, lo))
    rungs = []
    c = lo_cap
    while c <= hi_cap:
        rungs.append(c)
        c = pow2_capacity(c + 1)
    return rungs


@dataclasses.dataclass
class IndexData:
    """One sorted (key[, lo], val) extension index.

    key: [cap] int32 (narrow) or int64, nondecreasing, sentinel-padded
    val: [cap] int32, nondecreasing within equal keys, 0-padded
    n:   0-d int32 tensor, number of live entries
    lo:  [cap] int64 or None — the lo word of a composite key (3-4 bound
         columns), int64-max padded; entries sort by (key, lo, val)
    """

    key: torch.Tensor
    val: torch.Tensor
    n: torch.Tensor
    lo: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.key.shape[0]

    @property
    def device(self) -> torch.device:
        return self.key.device

    @property
    def composite(self) -> bool:
        return self.lo is not None


# A packed probe key: one tensor (<= 2 bound columns) or a (hi, lo) pair.
PackedKey = Union[torch.Tensor, np.ndarray, Tuple]


def pack_key(cols: Sequence) -> PackedKey:
    """Pack 1..4 non-negative int32 columns (numpy or torch) into a
    lexicographic key: ``c0`` or ``c0<<32 | c1`` (int64); 3 columns give
    the composite pair ``(c0, c1<<32|c2)`` (hi stays one column, so it may
    be narrowed to int32), 4 columns ``(c0<<32|c1, c2<<32|c3)``."""
    cols = tuple(cols)
    if isinstance(cols[0], torch.Tensor):
        c = [x.to(torch.int64) for x in cols]
    else:
        c = [np.asarray(x).astype(np.int64) for x in cols]
    if len(c) == 1:
        return c[0]
    if len(c) == 2:
        return (c[0] << 32) | c[1]
    if len(c) == 3:
        return c[0], (c[1] << 32) | c[2]
    if len(c) == 4:
        return (c[0] << 32) | c[1], (c[2] << 32) | c[3]
    raise ValueError(
        f"composite keys cover at most 4 int32 columns, got {len(c)}")


def unpack_key(packed, num_cols: int) -> np.ndarray:
    """Inverse of :func:`pack_key` (host): [N, num_cols] int32 columns."""
    M = 0xFFFFFFFF
    if num_cols <= 2:
        p = np.asarray(packed, np.int64)
        if num_cols == 1:
            return p[:, None].astype(np.int32)
        return np.stack([(p >> 32).astype(np.int32),
                         (p & M).astype(np.int32)], 1)
    hi, lo = (np.asarray(packed[0], np.int64), np.asarray(packed[1],
                                                          np.int64))
    if num_cols == 3:
        cols = [hi.astype(np.int32)]
    else:
        cols = [(hi >> 32).astype(np.int32), (hi & M).astype(np.int32)]
    cols.extend([(lo >> 32).astype(np.int32), (lo & M).astype(np.int32)])
    return np.stack(cols, 1)


def single_word_hi(num_key_cols: int) -> bool:
    """True when the packed key holds at most one int32 column — the
    precondition for the narrow (int32) key dtype."""
    return num_key_cols in (0, 1, 3)


def build_index(tuples: np.ndarray, key_pos: Tuple[int, ...], ext_pos: int,
                capacity: int | None = None, narrow: bool | None = None,
                device=None) -> IndexData:
    """Build an IndexData from host relation tuples [T, arity].

    Projects to (key columns, ext column), dedups, sorts on the host and
    uploads once to ``device`` (see :func:`resolve_device`).  ``narrow``
    overrides the key-dtype choice (the store decides it once per
    projection so folds keep one dtype)."""
    device = resolve_device(device)
    tuples = np.asarray(tuples)
    if tuples.ndim != 2:
        raise ValueError("tuples must be [T, arity]")
    key = pack_key(tuple(tuples[:, p].astype(np.int32) for p in key_pos)) \
        if key_pos else np.zeros(tuples.shape[0], np.int64)
    val = tuples[:, ext_pos].astype(np.int32)
    lo = None
    if isinstance(key, tuple):  # composite (hi, lo): 3-4 bound columns
        key, lo, val = _unique_rows3(key[0], key[1], val)
    else:
        key, val = _unique_pairs(key, val)
    n = key.shape[0]
    cap = round_capacity(max(int(capacity or n), n, 1))
    if narrow is None:
        narrow = single_word_hi(len(key_pos)) and (n == 0
                                                   or key.max() < SENTINEL32)
    narrow = narrow and single_word_hi(len(key_pos))
    kdt, sent = (np.int32, SENTINEL32) if narrow else (np.int64, SENTINEL)
    out_k = np.full(cap, sent, kdt)
    out_v = np.zeros(cap, np.int32)
    out_k[:n] = key.astype(kdt)
    out_v[:n] = val
    out_lo = None
    if lo is not None:
        out_lo = np.full(cap, SENTINEL, np.int64)
        out_lo[:n] = lo
        out_lo = torch.from_numpy(out_lo).to(device)
    return IndexData(torch.from_numpy(out_k).to(device),
                     torch.from_numpy(out_v).to(device),
                     torch.tensor(n, dtype=torch.int32, device=device),
                     out_lo)


def _unique_pairs(key: np.ndarray, val: np.ndarray):
    """Lexicographically sorted distinct (key, val) pairs — the rows of
    ``np.unique(np.stack([key, val], 1), axis=0)``, by one lexsort."""
    order = np.lexsort((val, key))
    key, val = key[order], val[order]
    keep = np.ones(key.shape[0], bool)
    keep[1:] = (key[1:] != key[:-1]) | (val[1:] != val[:-1])
    return key[keep], val[keep]


def _unique_rows3(hi: np.ndarray, lo: np.ndarray, val: np.ndarray):
    """Sorted distinct (hi, lo, val) rows of a composite key — the rows of
    ``np.unique(np.stack([hi, lo, val], 1), axis=0)``, by one lexsort."""
    order = np.lexsort((val, lo, hi))
    hi, lo, val = hi[order], lo[order], val[order]
    keep = np.ones(hi.shape[0], bool)
    keep[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1]) | \
        (val[1:] != val[:-1])
    return hi[keep], lo[keep], val[keep]


# ---------------------------------------------------------------------------
# Hash partitioning over the workers of a mesh (§3.2): host-built shards and
# the device routing (``distributed.owner_of``) MUST agree, so both go
# through the one hash below.
# ---------------------------------------------------------------------------

# Fibonacci-style multiplicative mix of the routing hash
SHARD_MIX = 0x9E3779B97F4A7C15
# second mix, folding a composite key's two words into one routing word
SHARD_MIX2 = 0xC2B2AE3D27D4EB4F


def _as_int64(c: int) -> int:
    """A 64-bit constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def combine_key(hi, lo):
    """Fold a composite (hi, lo) key into ONE 64-bit routing word,
    ``(hi * SHARD_MIX2) ^ lo`` modulo 2^64, as int64 (numpy or torch).
    Collisions only affect placement, never answers."""
    if isinstance(hi, torch.Tensor):
        # int64 products wrap modulo 2^64: the uint64 product's bits
        return (hi.to(torch.int64) * _as_int64(SHARD_MIX2)) ^ \
            lo.to(torch.int64)
    h = (np.asarray(hi).astype(np.uint64) * np.uint64(SHARD_MIX2)) ^ \
        np.asarray(lo).astype(np.uint64)
    return h.astype(np.int64)


def shard_of(key: PackedKey, num_shards: int):
    """Hash-partition owner of each packed key (a (hi, lo) pair folds
    through :func:`combine_key` first), int32 in [0, num_shards):
    ``((key * SHARD_MIX) mod 2^64 >> 33) % num_shards``.  numpy in, numpy
    out; a torch tensor in gives a tensor on its device."""
    if isinstance(key, tuple):
        key = combine_key(*key)
    w = max(int(num_shards), 1)
    if isinstance(key, torch.Tensor):
        h = ((key.to(torch.int64) * _as_int64(SHARD_MIX)) >> 33) & \
            0x7FFFFFFF  # the logical shift of the uint64 product
        return (h % w).to(torch.int32)
    h = (np.asarray(key).astype(np.uint64) * np.uint64(SHARD_MIX)) >> \
        np.uint64(33)
    return (h % np.uint64(w)).astype(np.int32)


def build_sharded_index(tuples: np.ndarray, key_pos: Tuple[int, ...],
                        ext_pos: int, num_shards: int,
                        capacity: int | None = None,
                        narrow: bool | None = None,
                        device=None,
                        workers: Tuple[int, int] | None = None
                        ) -> IndexData:
    """Hash-partition one extension index over ``num_shards`` workers.

    Returns an IndexData whose tensors carry a leading [w] worker axis
    (key/val/lo: [w, cap]; n: [w]); ``VersionedIndex.worker_shard(i)``
    selects one worker's shard.  Every (key, val) pair lands on exactly
    one worker, ``shard_of(key, w)``: the sum of live entries over the
    workers equals the unsharded index's (the paper's memory linearity,
    §3.2).  The per-shard capacity is uniform, the SEG-aligned power of two
    of the largest shard (``capacity`` is a per-shard floor); the key
    width is decided once for every shard.  Built on the host, uploaded
    once to ``device`` (see :func:`resolve_device`).  ``workers=(lo,
    hi)`` uploads the shards of workers lo..hi-1 only (a rank's,
    ``launch.mesh.WorkerMesh.span``): the partition, the capacity and the
    key width are still decided over every shard, so they are those rows
    of the whole partition."""
    device = resolve_device(device)
    tuples = np.asarray(tuples)
    if tuples.ndim != 2:
        raise ValueError("tuples must be [T, arity]")
    w = max(int(num_shards), 1)
    key = pack_key(tuple(tuples[:, p].astype(np.int32) for p in key_pos)) \
        if key_pos else np.zeros(tuples.shape[0], np.int64)
    val = tuples[:, ext_pos].astype(np.int32)
    if isinstance(key, tuple):  # composite: ownership by the combined word
        key, klo, val = _unique_rows3(key[0], key[1], val)
        own = shard_of((key, klo), w)
    else:
        key, val = _unique_pairs(key, val)
        klo = None
        own = shard_of(key, w)
    counts = np.bincount(own, minlength=w).astype(np.int64)
    cmax = int(counts.max()) if counts.size else 0
    cap = max(pow2_capacity(cmax), round_capacity(int(capacity or 1)))
    if narrow is None:
        narrow = single_word_hi(len(key_pos)) and (key.size == 0
                                                   or key.max() < SENTINEL32)
    narrow = narrow and single_word_hi(len(key_pos))
    kdt, sent = (np.int32, SENTINEL32) if narrow else (np.int64, SENTINEL)
    first, last = (0, w) if workers is None else workers
    if not 0 <= first < last <= w:
        raise ValueError(f"workers {workers} are not a range of the {w}")
    out_k = np.full((last - first, cap), sent, kdt)
    out_v = np.zeros((last - first, cap), np.int32)
    out_lo = None if klo is None else \
        np.full((last - first, cap), SENTINEL, np.int64)
    # rows are lex-sorted by (key[, lo], val); a stable sort by owner
    # keeps each shard's rows sorted, the IndexData invariant
    order = np.argsort(own, kind="stable")
    sk, sv = key[order].astype(kdt), val[order]
    sl = klo[order] if klo is not None else None
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    for i in range(first, last):
        lo, hi = offs[i], offs[i + 1]
        out_k[i - first, :hi - lo] = sk[lo:hi]
        out_v[i - first, :hi - lo] = sv[lo:hi]
        if out_lo is not None:
            out_lo[i - first, :hi - lo] = sl[lo:hi]
    return IndexData(
        torch.from_numpy(out_k).to(device), torch.from_numpy(out_v).to(device),
        torch.from_numpy(counts[first:last].astype(np.int32)).to(device),
        None if out_lo is None else torch.from_numpy(out_lo).to(device))


def shard_view(d: IndexData, k: int) -> IndexData:
    """Worker ``k``'s region of a sharded IndexData ([w, cap], counts
    [w]): views, no copy."""
    return IndexData(d.key[k], d.val[k], d.n[k],
                     None if d.lo is None else d.lo[k])


def stack_shards(parts) -> IndexData:
    """The sharded IndexData of per-worker regions of one capacity."""
    parts = list(parts)
    return IndexData(torch.stack([p.key for p in parts]),
                     torch.stack([p.val for p in parts]),
                     torch.stack([p.n.reshape(()) for p in parts]),
                     None if parts[0].lo is None
                     else torch.stack([p.lo for p in parts]))


def empty_index(capacity: int = 1, narrow: bool = True,
                composite: bool = False, device=None) -> IndexData:
    """Empty IndexData; ``narrow`` applies to the hi word only (a composite
    ``lo`` is always int64)."""
    device = resolve_device(device)
    cap = round_capacity(capacity)
    key, val, lo = _empty_like_caps(torch.int32 if narrow else torch.int64,
                                    cap, device, composite)
    return IndexData(key, val, torch.zeros((), dtype=torch.int32,
                                           device=device), lo)


def sentinel_of(dtype: torch.dtype) -> int:
    return SENTINEL32 if dtype == torch.int32 else SENTINEL


def _empty_like_caps(key_dtype, capacity: int, device,
                     composite: bool = False):
    """(key, val, lo) padding of the IndexData layout: key sentinel by
    dtype, val 0, lo int64-max (None unless composite)."""
    return (torch.full((capacity,), sentinel_of(key_dtype), dtype=key_dtype,
                       device=device),
            torch.zeros(capacity, dtype=torch.int32, device=device),
            torch.full((capacity,), SENTINEL, dtype=torch.int64,
                       device=device) if composite else None)


def _common(a: torch.Tensor, b: torch.Tensor):
    """Promote two integer tensors to one dtype (never truncate)."""
    if a.dtype == b.dtype:
        return a, b
    return a.to(torch.int64), b.to(torch.int64)


# ---------------------------------------------------------------------------
# Queries (vectorized over a batch of probes).
# ---------------------------------------------------------------------------

def index_range(idx: IndexData, qkey: PackedKey
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, count) int32 of the extension list for each packed key [B]
    (a (hi, lo) pair for a composite index).

    Searches the FULL capacity: sentinel padding sorts above every real
    key, so no live-count mask is needed."""
    if idx.lo is not None:
        qh, ql = qkey
        cap_n = torch.tensor(idx.capacity, dtype=torch.int32,
                             device=idx.device)
        cols = (idx.key, idx.lo)
        start = lex_searchsorted_cols(cols, cap_n, (qh, ql), "left")
        end = lex_searchsorted_cols(cols, cap_n, (qh, ql), "right")
        return start, end - start
    key, q = _common(idx.key, qkey)
    start = torch.searchsorted(key, q, side="left")
    end = torch.searchsorted(key, q, side="right")
    return start.to(torch.int32), (end - start).to(torch.int32)


def index_count(idx: IndexData, qkey: PackedKey) -> torch.Tensor:
    """Extension count of each packed key [B], int32."""
    return index_range(idx, qkey)[1]


def index_kth(idx: IndexData, start: torch.Tensor, k: torch.Tensor
              ) -> torch.Tensor:
    """k-th extension given the range start (no bounds check: the caller
    masks; positions clamp into the capacity)."""
    pos = (start.long() + k.long()).clamp(0, idx.capacity - 1)
    return idx.val[pos]


def search_depth(cap: int) -> int:
    """Iterations of the fixed-depth binary search over ``cap`` entries
    (+1: an interval of length 1 still needs one comparison)."""
    return max(int(np.ceil(np.log2(max(cap, 2)))), 1) + 1


def lex_searchsorted_cols(cols: Tuple[torch.Tensor, ...], n: torch.Tensor,
                          qcols: Tuple[torch.Tensor, ...],
                          side: str = "left") -> torch.Tensor:
    """Lower/upper bound of each lex query among the first ``min(cap, n)``
    rows of up to three lex-sorted columns ((key, val) or the composite
    (key, lo, val)); ``side="left"`` counts entries strictly below each
    query, ``side="right"`` entries <= it.  int32 [B]."""
    cap = cols[0].shape[0]
    right = side == "right"
    shape = qcols[0].shape
    dev = qcols[0].device
    lo = torch.zeros(shape, dtype=torch.int32, device=dev)
    hi = torch.minimum(torch.as_tensor(cap, dtype=torch.int32, device=dev),
                       n.to(torch.int32)).expand(shape)
    for _ in range(search_depth(cap)):
        mid = (lo + hi) >> 1
        midc = mid.clamp(0, cap - 1).long()
        less = torch.zeros(shape, dtype=torch.bool, device=dev)
        eq = torch.ones(shape, dtype=torch.bool, device=dev)
        for c, q in zip(cols, qcols):
            mc = c[midc]  # mixed-width compares promote, never truncate
            less = less | (eq & (mc < q))
            eq = eq & (mc == q)
        if right:
            less = less | eq
        active = lo < hi
        lo = torch.where(less & active, mid + 1, lo)
        hi = torch.where(~less & active, mid, hi)
    return lo


def lex_searchsorted(key, val, n, qk, qv, side: str = "left"):
    """Two-column (key, val) lex bound."""
    return lex_searchsorted_cols((key, val), n, (qk, qv), side)


def index_member(idx: IndexData, qkey: PackedKey, qval: torch.Tensor
                 ) -> torch.Tensor:
    """Membership of (qkey, qval) in the index, [B] bool — the plain
    reference of the membership kernels (``qkey`` a (hi, lo) pair for a
    composite index)."""
    qv = qval.to(torch.int32)
    if idx.lo is None:
        pos = lex_searchsorted(idx.key, idx.val, idx.n, qkey, qv)
        pos_c = pos.clamp(0, idx.capacity - 1).long()
        hit = (idx.key[pos_c] == qkey) & (idx.val[pos_c] == qv)
        return hit & (pos < idx.n)
    qh, ql = qkey
    pos = lex_searchsorted_cols((idx.key, idx.lo, idx.val), idx.n,
                                (qh, ql, qv))
    pos_c = pos.clamp(0, idx.capacity - 1).long()
    hit = ((idx.key[pos_c] == qh) & (idx.lo[pos_c] == ql)
           & (idx.val[pos_c] == qv))
    return hit & (pos < idx.n)


# ---------------------------------------------------------------------------
# Sorted-merge fold primitives (device-resident region maintenance).
#
# An existing index is updated by rank-based sorted merge against a sorted
# delta.  With both ranks of every entry in the other set, union / diff /
# intersect are static-shape scatters:
#
#     merge position of a[i] in a ∪ b  =  i + |{kept b < a[i]}|
#     merge position of b[j] in a ∪ b  =  |{a < b[j]}| + |{kept b before j}|
#     a[i] ∈ b                         ⇔  |{b <= a[i]}| > |{b < a[i]}|
# ---------------------------------------------------------------------------

def index_ranks(a: IndexData, qk: PackedKey, qv: torch.Tensor,
                plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lt, le) int32 [B]: entries of ``a`` lexicographically < / <= each
    (qk[, qlo], qv) query.  Goes through the merge-rank kernel wrapper
    (kernel on a CUDA tensor, plain search on a CPU one); ``plain`` forces
    the plain search on any device (the plain versions of the fold
    kernels)."""
    from repro_torch.kernels.merge import ops, ref
    qv = qv.to(torch.int32)
    fn = ref.rank_ref if plain else ops.rank_lt_le
    if a.lo is not None:
        qh, ql = qk
        return fn(a.key, a.val, a.n, qh.to(torch.int64), qv, lo=a.lo,
                  qlo=ql.to(torch.int64))
    return fn(a.key, a.val, a.n, qk.to(a.key.dtype), qv)


def _qcols_of(d: IndexData) -> PackedKey:
    """An index's own keys viewed as a probe batch (for rank queries)."""
    return d.key if d.lo is None else (d.key, d.lo)


def _scatter_drop(dst: torch.Tensor, pos: torch.Tensor, src: torch.Tensor):
    """``dst.at[pos].set(src, mode="drop")``: writes whose position is out
    of range are dropped (positions are unique where they are in range)."""
    at = ((pos >= 0) & (pos < dst.shape[0])).nonzero().squeeze(1)
    dst[pos[at].long()] = src[at]


def _merge_core(a: IndexData, b: IndexData, capacity: int,
                plain: bool = False) -> IndexData:
    """Sorted union a ∪ b into a fresh IndexData of static ``capacity``
    (entries present in both appear once; overflowing entries drop)."""
    cap = int(capacity)
    dev = a.device
    ii = torch.arange(a.capacity, dtype=torch.int32, device=dev)
    jj = torch.arange(b.capacity, dtype=torch.int32, device=dev)
    a_live = ii < a.n
    b_live = jj < b.n
    lt_a, le_a = index_ranks(a, _qcols_of(b), b.val, plain)  # b in a
    keep_b = b_live & ~(le_a > lt_a)
    kb = keep_b.to(torch.int32)
    kept_cum = torch.cumsum(kb, 0, dtype=torch.int32)
    kept_excl = kept_cum - kb
    pos_b = torch.where(keep_b, lt_a + kept_excl, cap)
    lt_b, _ = index_ranks(b, _qcols_of(a), a.val, plain)  # a in b
    # kept-b entries strictly below a[i] = prefix of keep_b over [0, lt_b)
    below = torch.where(
        lt_b > 0, kept_cum[(lt_b - 1).clamp(0, b.capacity - 1).long()], 0)
    pos_a = torch.where(a_live, ii + below, cap)
    out_k, out_v, out_lo = _empty_like_caps(a.key.dtype, cap, dev,
                                            a.lo is not None)
    _scatter_drop(out_k, pos_a, a.key)
    _scatter_drop(out_k, pos_b, b.key.to(a.key.dtype))
    _scatter_drop(out_v, pos_a, a.val)
    _scatter_drop(out_v, pos_b, b.val)
    if out_lo is not None:
        _scatter_drop(out_lo, pos_a, a.lo)
        _scatter_drop(out_lo, pos_b, b.lo)
    n = a.n.to(torch.int32) + kb.sum(dtype=torch.int32)
    return IndexData(out_k, out_v, n, out_lo)


def _select_core(a: IndexData, b: IndexData, capacity: int, keep_in_b: bool,
                 plain: bool = False) -> IndexData:
    """Compact the entries of ``a`` (not) in ``b`` into static ``capacity``:
    keep_in_b=False is a \\ b (diff), True is a ∩ b (intersect)."""
    cap = int(capacity)
    ii = torch.arange(a.capacity, dtype=torch.int32, device=a.device)
    lt, le = index_ranks(b, _qcols_of(a), a.val, plain)
    in_b = le > lt
    keep = (ii < a.n) & (in_b if keep_in_b else ~in_b)
    k = keep.to(torch.int32)
    cum = torch.cumsum(k, 0, dtype=torch.int32)
    pos = torch.where(keep, cum - 1, cap)
    out_k, out_v, out_lo = _empty_like_caps(a.key.dtype, cap, a.device,
                                            a.lo is not None)
    _scatter_drop(out_k, pos, a.key)
    _scatter_drop(out_v, pos, a.val)
    if out_lo is not None:
        _scatter_drop(out_lo, pos, a.lo)
    return IndexData(out_k, out_v, k.sum(dtype=torch.int32), out_lo)


# The public folds: the tensors' device picks the path (merge ranks through
# the rank kernel, 1-word or composite, on CUDA; the plain search on CPU).

def merge_index(a: IndexData, b: IndexData, capacity: int) -> IndexData:
    """Sorted union a ∪ b at static ``capacity`` (see :func:`_merge_core`)."""
    return _merge_core(a, b, capacity)


def diff_index(a: IndexData, b: IndexData, capacity: int) -> IndexData:
    """Sorted difference a \\ b at static ``capacity``."""
    return _select_core(a, b, capacity, False)


def intersect_index(a: IndexData, b: IndexData, capacity: int) -> IndexData:
    """Sorted intersection a ∩ b at static ``capacity`` (probe-sized:
    O(|a|·log|b|))."""
    return _select_core(a, b, capacity, True)


# ---------------------------------------------------------------------------
# Graph convenience: the dual-CSR edge index.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Graph:
    """A directed graph as an edge list (numpy host container)."""

    edges: np.ndarray  # [E, 2] int32 (src, dst), deduped
    num_vertices: int

    @classmethod
    def from_edges(cls, edges: np.ndarray, num_vertices: int | None = None,
                   dedup: bool = True) -> "Graph":
        edges = np.asarray(edges, np.int32).reshape(-1, 2)
        if dedup and edges.size:
            edges = np.unique(edges, axis=0)
        nv = int(num_vertices if num_vertices is not None
                 else (edges.max() + 1 if edges.size else 0))
        return cls(edges, nv)

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    def forward(self, capacity: int | None = None, device=None
                ) -> IndexData:
        """src -> dst (out-neighbour) index on ``device`` (see
        :func:`resolve_device`)."""
        return build_index(self.edges, (0,), 1, capacity, device=device)

    def reverse(self, capacity: int | None = None, device=None
                ) -> IndexData:
        """dst -> src (in-neighbour) index on ``device``."""
        return build_index(self.edges, (1,), 0, capacity, device=device)

    def undirected(self) -> "Graph":
        e = np.concatenate([self.edges, self.edges[:, ::-1]], axis=0)
        return Graph.from_edges(e, self.num_vertices)

    def degree_relabel(self) -> "Graph":
        """Symmetry-breaking preprocessing (§5.4): relabel vertices by
        (degree, id) ascending and keep edges oriented low->high id."""
        deg = np.zeros(self.num_vertices, np.int64)
        np.add.at(deg, self.edges[:, 0], 1)
        np.add.at(deg, self.edges[:, 1], 1)
        order = np.lexsort((np.arange(self.num_vertices), deg))
        rank = np.empty(self.num_vertices, np.int32)
        rank[order] = np.arange(self.num_vertices, dtype=np.int32)
        e = rank[self.edges]
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        keep = lo != hi
        return Graph.from_edges(np.stack([lo[keep], hi[keep]], 1),
                                self.num_vertices)
