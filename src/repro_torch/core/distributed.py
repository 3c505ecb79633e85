"""Distributed BiGJoin over a mesh of w workers (§3.2 / §3.4).

Every extension index is hash-partitioned by its packed key
(``owner_of``), so the cluster-wide memory is O(IN): each index entry is
held by exactly one worker, the paper's linear-memory property.

Lookups are *request/response*: a worker keeps its popped prefixes and
sends (key) / (key, k) / (key, val) requests to the owners, the three
distributed index services of BiGJoin-S (§3.4.1):

    count     C(p)          key        -> |Ext(p)|
    resolve   Ext-Res(p,k)  (key,k)    -> k-th extension
    member    Ext(p·e)      (key,val)  -> membership / deletion bits

Requests travel through a fixed-capacity bucketed all-to-all
(``route_capacity`` slots per peer pair).  An overflowing request is not
dropped: its prefix does not advance its rem-ext cursor past it this round
and retries (backpressure, not failure).  With BiGJoin-S aggregation
(``aggregate=True``, one request per distinct key) the balls-into-bins
bound of Thm 3.4 makes overflow improbable at capacity O(B'/w · polylog).

**The workers are a leading [wl] axis of each rank.**  The mesh's w
workers run on R ``torch.distributed`` ranks (``launch.mesh``), each rank
holding ``wl = w / R`` of them as dim 0 of every tensor of the dataflow;
R = 1 is one process holding all w.  The three exchanges of the dataflow
are in ``core.exchange``: :func:`all_to_all`, :func:`psum` and
:func:`pmax`, local transposes and reductions inside a rank and one
collective each between ranks.  Per-worker arithmetic (queue compaction,
cumsums, argsorts, searches) is batched over the rank's workers; routing
(``owner_of``) names global workers, and a rank's owners answer their
requests one owner at a time from their shard
(``VersionedIndex.worker_shard``), so a member service is wl calls of the
membership kernel on the card.  The host reads one stack of queue sizes
a step, summed over every worker of the mesh, to pick the level, so every
rank takes the same branch and stops on the same step.  Outputs stay on
the producing worker until the end; counts and counters are summed over
the mesh, and collected rows gathered in worker order on every rank.

The streaming half (§4) rides the same dataflow: :class:`DistDeltaBigJoin`
keeps its regions in a worker-sharded ``RegionStore`` (``shard_w = w``),
deals each delta query's signed seed batch round-robin over the workers
(:func:`deal_seed`) and launches one :class:`DistributedProgram` a delta
plan and epoch through :func:`run_program`, where the ``dist.program``
fault point fires.  The program cache (:func:`get_distributed_program`)
keeps one program a (plan, config, mesh), as the JAX package's does;
eager PyTorch compiles nothing per shape, so the JAX program's ``warm``
has no counterpart.  The dry-run lowering is not part of this module.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core import compilestats, csr
from repro_torch.core import delta as _delta
from repro_torch.core.bigjoin import (BigJoinConfig, Indices, JoinResult,
                                      LevelQueue, seed_tuples_for)
from repro_torch.core.dataflow_index import VersionedIndex
from repro_torch.core.exchange import all_to_all, gather_rows, pmax, psum
from repro_torch.core.plan import Plan
from repro_torch.errors import (CapacityOverflow, ESCALATES_BATCH,
                                ESCALATES_OUT, ESCALATES_ROUTE, OVF_OUT,
                                OVF_QUEUE, OVF_ROUTE, OVF_SEED, _KIND_BITS)
from repro_torch.launch.mesh import (DEFAULT_WORKERS, WorkerMesh,
                                     make_host_mesh)

INF = int(np.iinfo(np.int32).max)


# ---------------------------------------------------------------------------
# hashing / partitioning
# ---------------------------------------------------------------------------

def owner_of(key, w: int):
    """Worker owning each packed key (a composite (hi, lo) pair folds into
    one routing word first): the hash of ``csr.shard_of``, which places
    the shards, so routing and placement agree."""
    return csr.shard_of(key, w)


owner_of_np = owner_of  # the JAX package's name for its numpy form


# region-name subsets backing each logical version (delta.py / §4.3):
# pos regions contribute extensions, neg regions subtract membership.
VERSION_REGIONS = {
    "static": (("base",), ()),
    "old": (("base", "cins"), ("cdel",)),
    "new": (("base", "cins", "uins"), ("cdel", "udel")),
}


def partition_indices(plan: Plan, relations: Dict[str, np.ndarray],
                      w: int, region_tuples: Optional[Dict] = None,
                      device=None, mesh: Optional[WorkerMesh] = None
                      ) -> Dict[str, VersionedIndex]:
    """Hash-partition every index the plan needs over ``w`` workers, on
    ``device`` (see ``csr.resolve_device``), keeping the shards of the
    workers ``mesh``'s rank holds (every shard without a mesh).

    Static versions partition ``relations[rel]`` directly.  Delta versions
    ("old"/"new") partition each region of the projection:
    ``region_tuples[(rel, key_pos, ext_pos)]`` maps the region names
    (base/cins/cdel/uins/udel) to host tuple arrays.  Every region entry
    is owned by exactly one worker per projection: sharding never
    replicates, it only splits.  The indices' tensors carry a leading [wl]
    axis: each rank builds the whole partition on the host from the same
    relations and uploads its workers' rows of it."""
    device = csr.resolve_device(device)
    if mesh is None:
        mesh = make_host_mesh(w, device)
    elif mesh.num_workers != w:
        raise ValueError(f"{w} workers on a mesh of {mesh.num_workers}")
    span = mesh.span
    out: Dict[str, VersionedIndex] = {}
    for index_id, rel, key_pos, ext_pos, version in plan.index_ids():
        if version == "static":
            base = csr.build_sharded_index(np.asarray(relations[rel]),
                                           key_pos, ext_pos, w,
                                           device=device, workers=span)
            out[index_id] = VersionedIndex((base,), ())
            continue
        if region_tuples is None:
            raise ValueError(
                f"plan index {index_id} reads version {version!r}: pass "
                "region_tuples with base/cins/cdel/uins/udel host arrays")
        regions = region_tuples[(rel, key_pos, ext_pos)]
        pos_names, neg_names = VERSION_REGIONS[version]
        arity = max(max(key_pos, default=0), ext_pos) + 1

        def shard(name):
            rows = np.asarray(regions[name])
            if rows.ndim != 2:  # flat arrays: minimal covering arity
                rows = rows.reshape(-1, arity)
            return csr.build_sharded_index(rows, key_pos, ext_pos, w,
                                           device=device, workers=span)

        out[index_id] = VersionedIndex(
            tuple(shard(nm) for nm in pos_names),
            tuple(shard(nm) for nm in neg_names))
    return out


def index_bytes(indices: Dict[str, VersionedIndex]) -> int:
    """Device bytes of the regions of ``indices`` this process holds."""
    return sum(t.nbytes for vi in indices.values() for d in vi.pos + vi.neg
               for t in (d.key, d.val, d.n, d.lo) if t is not None)


# ---------------------------------------------------------------------------
# per-worker helpers over the leading [wl] axis
# ---------------------------------------------------------------------------

def _ar(idx: torch.Tensor) -> torch.Tensor:
    """Worker ids shaped to broadcast against ``idx`` [w, ...]."""
    return torch.arange(idx.shape[0], device=idx.device).view(
        (-1,) + (1,) * (idx.dim() - 1))


def _rows(x, idx: torch.Tensor):
    """``x[i, idx[i]]`` for every worker i (a key pair maps over its two
    words): x [w, N, ...], idx [w, ...]."""
    if isinstance(x, tuple):
        return tuple(_rows(c, idx) for c in x)
    return x[_ar(idx), idx.long()]


def _put(dst: torch.Tensor, pos: torch.Tensor, src: torch.Tensor
         ) -> torch.Tensor:
    """Per worker ``dst.at[pos].set(src, mode="drop")``, into a new tensor:
    dst [w, cap, ...], pos [w, N], src [w, N, ...]; positions outside
    [0, cap) drop (in-range positions are unique)."""
    cap = dst.shape[1]
    out = torch.cat([dst, dst[:, :1]], 1)  # one slot that takes the drops
    pos = torch.where((pos >= 0) & (pos < cap), pos, cap).long()
    out[_ar(pos), pos] = src
    return out[:, :cap]


def _compact(arrays, keep: torch.Tensor):
    """Stable-partition each worker's rows with keep=True to the front;
    returns the new [w] sizes."""
    perm = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    return [_rows(a, perm) for a in arrays], keep.sum(1, dtype=torch.int32)


def _append(dsts, size: torch.Tensor, srcs, alive: torch.Tensor):
    """Append each worker's alive rows of every src to its dst at
    [size, ...), in place (rows past the capacity drop); returns (dsts,
    n_new [w], overflow [w])."""
    cap = dsts[0].shape[1]
    a = alive.to(torch.int32)
    cum = torch.cumsum(a, 1, dtype=torch.int32) - a
    dest = size[:, None] + cum
    n_new = a.sum(1, dtype=torch.int32)
    ovf = (size + n_new) > cap
    wi, j = (alive & (dest < cap)).nonzero(as_tuple=True)
    at = dest[wi, j].long()
    for d, s in zip(dsts, srcs):
        d[wi, at] = s[wi, j]
    return list(dsts), n_new, ovf


def _window(arrays, size: torch.Tensor, B: int):
    """The popped window of a queue: (W, each array's first W rows, valid
    [w, W]) with W = min(B', capacity)."""
    W = min(B, arrays[0].shape[1])
    valid = torch.arange(W, dtype=torch.int32, device=size.device) < \
        size[:, None]
    return W, [a[:, :W] for a in arrays], valid


def _retire(arrays, size: torch.Tensor, W: int, consumed: torch.Tensor,
            ci: int, cursor: torch.Tensor):
    """Write each worker's advanced window cursors into ``arrays[ci]``,
    drop the consumed window rows and compact the live rest to the front:
    (arrays, new sizes [w])."""
    arrays = list(arrays)
    arrays[ci] = arrays[ci].clone()
    arrays[ci][:, :W] = cursor
    w, cap = arrays[0].shape[:2]
    live = torch.arange(cap, dtype=torch.int32, device=size.device) < \
        size[:, None]
    done = torch.zeros((w, cap), dtype=torch.bool, device=size.device)
    done[:, :W] = consumed
    return _compact(arrays, live & ~done)


def _segment_min(x: torch.Tensor, seg: torch.Tensor, num: int):
    """Per worker ``jax.ops.segment_min(x, seg, num)`` (int32 max where a
    segment is empty)."""
    out = torch.full((x.shape[0], num), INF, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(1, seg.long(), x, reduce="amin",
                              include_self=True)


def _key_w(prefix: torch.Tensor, positions, dtype):
    """Pack prefix columns [w, N, width] into a probe key [w, N] (or the
    composite (hi, lo) pair) cast to the index key dtype."""
    packed = csr.pack_key(tuple(prefix[..., p] for p in positions))
    if isinstance(packed, tuple):
        return packed
    return packed.to(dtype)


def _binding_key(prefix, bound_attrs, key_attrs, idx: VersionedIndex):
    pos = [list(bound_attrs).index(a) for a in key_attrs]
    return _key_w(prefix, pos, idx.pos[0].key.dtype)


def _words(key) -> Tuple[torch.Tensor, ...]:
    return key if isinstance(key, tuple) else (key,)


def _unwords(words, composite: bool):
    return tuple(words) if composite else words[0]


def _clip(x: torch.Tensor, lo, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: min(max(x, lo), hi)."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


# ---------------------------------------------------------------------------
# bounded-capacity request/response exchange
# ---------------------------------------------------------------------------

def remote_service(queries, dest: torch.Tensor, valid: torch.Tensor,
                   reply_fn, w: int, cap: int,
                   mesh: WorkerMesh):
    """Route each of the rank's workers' ``queries`` (a tuple of [wl, B]
    tensors) to the ``dest`` workers (global ids in [0, w)), apply
    ``reply_fn(owner, queries [w·cap]) -> tuple of [w·cap]`` at each of
    the rank's owners (``owner`` its local index; to every slot of its
    receive buffer, the empty ones included, as the JAX package does), and
    return (replies [wl, B] each, ok [wl, B], recv_load [wl] int64: the
    requests each worker served).  ok=False rows overflowed their
    per-peer capacity and got no reply."""
    dev = dest.device
    wl, B = dest.shape
    dest_eff = torch.where(valid, dest, w)
    order = torch.argsort(dest_eff, dim=1, stable=True)
    sdest = dest_eff.gather(1, order)
    first = torch.searchsorted(sdest, sdest, side="left").to(torch.int32)
    slot = torch.arange(B, dtype=torch.int32, device=dev) - first
    ok_sorted = (sdest < w) & (slot < cap)
    flat = torch.where(ok_sorted, sdest * cap + slot, w * cap)

    def scatter(x):
        buf = torch.zeros((wl, w * cap), dtype=x.dtype, device=dev)
        return _put(buf, flat, x.gather(1, order))

    send = [scatter(q) for q in queries]
    sent_mask = scatter(torch.ones((wl, B), dtype=torch.int32, device=dev))
    recv = [all_to_all(x, mesh) for x in send]
    recv_mask = all_to_all(sent_mask, mesh) > 0
    at_owner = [reply_fn(o, tuple(x[o] for x in recv)) for o in range(wl)]
    back = [all_to_all(torch.stack(col), mesh) for col in zip(*at_owner)]

    # row i's reply sits at (dest[i], slot of row i)
    slot_of_row = torch.zeros((wl, B), dtype=torch.int32, device=dev) \
        .scatter(1, order, slot)
    ok = torch.zeros((wl, B), dtype=torch.bool, device=dev) \
        .scatter(1, order, ok_sorted) & valid
    gidx = torch.clamp(dest * cap + slot_of_row, 0, w * cap - 1).long()
    replies = tuple(x.gather(1, gidx) for x in back)
    recv_load = recv_mask.sum(1)  # int64
    return replies, ok, recv_load


def service_bytes(slot_bytes: int, w: int, ranks: int, cap: int) -> int:
    """``exchange.EXCHANGE_BYTES`` of one :func:`remote_service` call on
    each rank of ``ranks``: every buffer of its all_to_alls is [wl,
    w·cap] (the request words, the int32 sent mask, the replies), and the
    (R - 1)/R of it addressed to other ranks' workers leaves the rank:
    wl·(w - wl)·cap·``slot_bytes``, the slot's words' bytes summed."""
    wl = w // ranks
    return wl * (w - wl) * cap * int(slot_bytes)


def step_exchange_bytes(plan: Plan, dcfg: "DistConfig", indices: Indices,
                        li: int, ranks: int) -> int:
    """``exchange.EXCHANGE_BYTES`` of one plain (no Balance) step at level
    ``li`` on each rank of ``ranks``, from the buffers' capacities (what
    the data fills does not change a buffer's size): each binding's count
    (the key's words, the mask, an int32 count), resolve (the key, an
    int32 offset, the mask, an int32 value) and membership (the key, an
    int32 value, the mask, the int32 bits) service calls, and the psum of
    the plan's queue sizes (int64 sums).  A key of 3-4 columns is two
    int64 words; any other is one word of its index's key dtype."""
    if dcfg.balance:
        raise ValueError("the model counts the plain step, not Balance's")
    w, cap = dcfg.num_workers, dcfg.route_capacity
    total = 0
    for b in plan.levels[li].bindings:
        key = indices[b.index_id].pos[0].key
        kb = 16 if len(b.key_attrs) > 2 else key.element_size()
        total += service_bytes(kb + 8, w, ranks, cap)
        total += 2 * service_bytes(kb + 12, w, ranks, cap)
    return total + (ranks - 1) * 8 * len(plan.levels)


def dedup_requests(key, valid: torch.Tensor):
    """BiGJoin-S aggregation (§3.4.2): collapse duplicate request keys of
    each worker.

    ``key`` is one [w, B] tensor or a tuple of them (composite keys dedup
    on the exact word tuple, never on a lossy hash).  Returns (rep_idx
    [w, B] -> representative row, is_rep [w, B]).  Only representative
    rows are routed; replies are read through rep_idx."""
    keys = _words(key)
    w, B = keys[0].shape
    dev = keys[0].device
    skeys = tuple(torch.where(valid, k, torch.iinfo(k.dtype).max)
                  for k in keys)
    if len(skeys) == 1:
        order = torch.argsort(skeys[0], dim=1, stable=True)
        sk = skeys[0].gather(1, order)
        first = torch.searchsorted(sk, sk, side="left")
    else:
        # lexsort with skeys[0] primary: stable sorts from the last word up
        order = torch.arange(B, device=dev).expand(w, B)
        for k in reversed(skeys):
            order = order.gather(
                1, torch.argsort(k.gather(1, order), dim=1, stable=True))
        sk = tuple(k.gather(1, order) for k in skeys)
        starts = torch.zeros((w, B), dtype=torch.bool, device=dev)
        starts[:, :1] = True
        for c in sk:
            starts[:, 1:] |= c[:, 1:] != c[:, :-1]
        # index of each sorted row's group head: running max of the starts
        first = torch.cummax(torch.where(
            starts, torch.arange(B, device=dev), 0), dim=1).values
    rep_sorted = order.gather(1, first)
    rep_idx = torch.zeros((w, B), dtype=torch.int64, device=dev) \
        .scatter(1, order, rep_sorted)
    is_rep = torch.zeros((w, B), dtype=torch.bool, device=dev) \
        .scatter(1, rep_idx, True) & valid
    return rep_idx.to(torch.int32), is_rep


# ---------------------------------------------------------------------------
# the three index services
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistConfig:
    base: BigJoinConfig
    num_workers: int
    route_capacity: int  # per peer-pair slots; <= batch
    aggregate: bool = True  # BiGJoin-S request dedup (§3.4.2)
    balance: bool = False  # BiGJoin-S Balance operator (§3.4.2)
    max_steps: int = 1 << 30


def _request(queries, dest, valid, reply, w, cap, dedup_key,
             mesh: WorkerMesh):
    """One service call: ``remote_service`` of the valid rows, or with
    BiGJoin-S aggregation when ``dedup_key`` is given (one request per
    distinct key, each row reading its representative's reply).  Returns
    (reply [wl, B], ok [wl, B], recv_load [wl]); invalid rows count as
    ok."""
    if dedup_key is None:
        (out,), ok, load = remote_service(queries, dest, valid, reply, w,
                                          cap, mesh)
        return out, ok | ~valid, load
    rep_idx, is_rep = dedup_requests(dedup_key, valid)
    (out,), ok, load = remote_service(queries, dest, is_rep, reply, w, cap,
                                      mesh)
    return _rows(out, rep_idx), _rows(ok, rep_idx) | ~valid, load


def _remote_count(idx: VersionedIndex, qkey, dest, valid, w, cap,
                  aggregate, mesh: WorkerMesh):
    composite = isinstance(qkey, tuple)

    def reply(o, q):
        return (idx.worker_shard(o).count(_unwords(q, composite)),)

    return _request(_words(qkey), dest, valid, reply, w, cap,
                    qkey if aggregate else None, mesh)


def _remote_resolve(idx: VersionedIndex, qkey, k, dest, valid, w, cap,
                    mesh: WorkerMesh):
    composite = isinstance(qkey, tuple)

    def reply(o, q):
        shard = idx.worker_shard(o)
        starts, counts = shard.ranges(_unwords(q[:-1], composite))
        return (shard.gather(starts, counts, q[-1]),)

    return _request(_words(qkey) + (k,), dest, valid, reply, w, cap,
                    None, mesh)


def _remote_member(idx: VersionedIndex, qkey, qval, dest, valid, w, cap,
                   aggregate, mesh: WorkerMesh):
    composite = isinstance(qkey, tuple)

    def reply(o, q):
        # membership and deletion bits of every region in one call: on
        # the card one launch of the membership kernel at each owner
        mem, dele = idx.worker_shard(o).signed_member(
            _unwords(q[:-1], composite), q[-1])
        return (mem.to(torch.int32) | (dele.to(torch.int32) << 1),)

    # dedup on the exact (key, val) tuple: packed into one word for narrow
    # int32 keys, an explicit word tuple for composite keys; wide int64
    # single-word keys cannot widen losslessly, so they skip aggregation
    if composite:
        pair = qkey + (qval.to(torch.int64),)
    elif qkey.dtype == torch.int32:
        pair = (qkey.to(torch.int64) << 32) | qval.to(torch.int64)
    else:
        pair = None
    bits, ok, load = _request(_words(qkey) + (qval,), dest, valid, reply, w,
                              cap, pair if aggregate else None, mesh)
    return (bits & 1) > 0, (bits & 2) > 0, ok, load


# ---------------------------------------------------------------------------
# the dataflow state, every field with a leading [wl] axis of the rank's
# workers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistState:
    queues: Tuple[LevelQueue, ...]  # prefix [wl, cap, width], size [wl]
    out_buf: torch.Tensor  # [wl, Ocap, m] int32 (Ocap 1 in count mode)
    out_weight: torch.Tensor  # [wl, Ocap] int32
    out_n: torch.Tensor  # [wl] int32
    out_count: torch.Tensor  # [wl] int64 weighted output count
    overflow: torch.Tensor  # [wl] int32 OVF_* bitmask
    proposals: torch.Tensor  # [wl] int64
    intersections: torch.Tensor  # [wl] int64
    recv_load: torch.Tensor  # [wl] int64 requests served


def make_state(plan: Plan, cfg: BigJoinConfig, wl: int, device,
               seed_capacity: int) -> DistState:
    """Empty queues and outputs of ``wl`` workers (a rank's)."""
    m = plan.query.num_attrs

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((wl,) + shape, dtype=dtype, device=device)

    queues = []
    for width in range(plan.seed_width, m):
        cap = seed_capacity if width == plan.seed_width \
            else cfg.queue_capacity()
        queues.append(LevelQueue(zeros(cap, width), zeros(cap), zeros(cap),
                                 zeros()))
    ocap = cfg.out_capacity if cfg.mode == "collect" else 1
    return DistState(tuple(queues), zeros(ocap, m), zeros(ocap), zeros(),
                     zeros(dtype=torch.int64), zeros(),
                     zeros(dtype=torch.int64), zeros(dtype=torch.int64),
                     zeros(dtype=torch.int64))


def _emit(plan: Plan, cfg: BigJoinConfig, li: int, state: DistState,
          queues, new_prefix, weight, alive):
    """Push the survivors of level ``li`` to the next queue, or to the
    output (count and, in collect mode, rows) at the last level.
    Returns (queues, out_buf, out_weight, out_n, out_count, overflow)."""
    out_buf, out_weight = state.out_buf, state.out_weight
    out_n, out_count = state.out_n, state.out_count
    overflow = state.overflow
    queues = list(queues)
    if li == len(plan.levels) - 1:
        out_count = out_count + (weight * alive).sum(1, dtype=torch.int64)
        if cfg.mode == "collect":
            perm = list(np.argsort(np.asarray(plan.attr_order)))
            (out_buf, out_weight), n_new, ovf = _append(
                [out_buf, out_weight], out_n,
                [new_prefix[..., perm], weight], alive)
            out_n = torch.clamp(out_n + n_new, max=out_buf.shape[1])
            overflow = overflow | torch.where(ovf, OVF_OUT, 0)
    else:
        nxt = queues[li + 1]
        (npfx, nk, nw), n_new, ovf = _append(
            [nxt.prefix, nxt.k, nxt.weight], nxt.size,
            [new_prefix, torch.zeros_like(weight), weight], alive)
        queues[li + 1] = LevelQueue(
            npfx, nk, nw, torch.clamp(nxt.size + n_new,
                                      max=nxt.prefix.shape[1]))
        overflow = overflow | torch.where(ovf, OVF_QUEUE, 0)
    return (tuple(queues), out_buf, out_weight, out_n, out_count,
            overflow.to(torch.int32))


def _propose_intersect(lv, dcfg: DistConfig, indices, wprefix, wmini, r,
                       k_off, pvalid, recv_load, qks, mesh: WorkerMesh):
    """Extension-Resolve and Intersect (Fig 3) of the proposals ``t`` of
    each worker: prefix row ``r``, extension offset ``k_off``, proposing
    binding ``wmini[r]``.  Returns (new_prefix, alive, incomplete,
    n_isect, recv_load)."""
    w, cap, B = dcfg.num_workers, dcfg.route_capacity, dcfg.base.batch
    wl = r.shape[0]
    new_bound = lv.bound_attrs + (lv.ext_attr,)
    dev = r.device
    if qks is None:
        qks = [_binding_key(wprefix, lv.bound_attrs, b.key_attrs,
                            indices[b.index_id]) for b in lv.bindings]
    mini_r = _rows(wmini, r)
    cand = torch.zeros((wl, B), dtype=torch.int32, device=dev)
    incomplete = torch.zeros((wl, B), dtype=torch.bool, device=dev)
    for bi, b in enumerate(lv.bindings):
        idx = indices[b.index_id]
        qk_r = _rows(qks[bi], r)
        mask = pvalid & (mini_r == bi)
        val, ok, load = _remote_resolve(idx, qk_r, k_off, owner_of(qk_r, w),
                                        mask, w, cap, mesh)
        cand = torch.where(mask, val, cand)
        incomplete = incomplete | (mask & ~ok)
        recv_load = recv_load + load
    new_prefix = torch.cat([_rows(wprefix, r), cand[..., None]], -1)
    alive = pvalid
    n_isect = torch.zeros(wl, dtype=torch.int64, device=dev)
    for bi, b in enumerate(lv.bindings):
        idx = indices[b.index_id]
        pos = [list(new_bound).index(a) for a in b.key_attrs]
        qk = _key_w(new_prefix, pos, idx.pos[0].key.dtype)
        mem, dele, ok, load = _remote_member(
            idx, qk, cand, owner_of(qk, w), pvalid, w, cap, dcfg.aggregate,
            mesh)
        recv_load = recv_load + load
        is_min = mini_r == bi
        keep = torch.where(is_min, ~dele, mem)
        n_isect = n_isect + (alive & ~is_min).sum(1)
        alive = alive & (keep | ~ok)  # unanswered rows defer, not die
        incomplete = incomplete | (pvalid & ~ok)
    for f in lv.filters:
        lo = new_prefix[..., list(new_bound).index(f.lo)]
        hi = new_prefix[..., list(new_bound).index(f.hi)]
        alive = alive & (lo < hi)
    return new_prefix, alive, incomplete, n_isect, recv_load


def _budget(remaining: torch.Tensor, B: int):
    """Each row's share of the B' proposal budget, in row order: (allowed,
    aacum) [w, W]."""
    acum = torch.cumsum(remaining, 1, dtype=torch.int32)
    allowed = _clip(B - (acum - remaining), 0, remaining).to(torch.int32)
    return allowed, torch.cumsum(allowed, 1, dtype=torch.int32)


def _expand(aacum, allowed, cursor, B: int):
    """Proposal t of each worker -> (row r, offset k_off, pvalid)."""
    w, W = aacum.shape
    t = torch.arange(B, dtype=torch.int32, device=aacum.device)
    pvalid = t < aacum[:, -1:]
    r = torch.clamp(torch.searchsorted(aacum, t.expand(w, B).contiguous(),
                                       side="right"), 0, W - 1)
    r = r.to(torch.int32)
    k_off = t - (_rows(aacum, r) - _rows(allowed, r)) + _rows(cursor, r)
    return r, k_off, pvalid


def _remote_counts(lv, dcfg: DistConfig, indices, wprefix, valid,
                   recv_load, mesh: WorkerMesh):
    """Remote count minimization: (qks, min_i, min_c, count_ok,
    recv_load)."""
    w, cap = dcfg.num_workers, dcfg.route_capacity
    qks, cnts, count_ok = [], [], valid
    for b in lv.bindings:
        idx = indices[b.index_id]
        qk = _binding_key(wprefix, lv.bound_attrs, b.key_attrs, idx)
        cnt, ok, load = _remote_count(idx, qk, owner_of(qk, w), valid, w,
                                      cap, dcfg.aggregate, mesh)
        qks.append(qk)
        cnts.append(cnt)
        count_ok = count_ok & ok
        recv_load = recv_load + load
    tot = torch.stack(cnts, -1)
    min_i = torch.argmin(tot, -1).to(torch.int32)
    min_c = tot.amin(-1)
    return qks, min_i, min_c, count_ok, recv_load


# ---------------------------------------------------------------------------
# the distributed level branch (bigjoin's level step with remote lookups
# and rem-ext deferral backpressure)
# ---------------------------------------------------------------------------

def _build_dist_level(plan: Plan, dcfg: DistConfig, li: int,
                      mesh: WorkerMesh):
    lv = plan.levels[li]
    B = dcfg.base.batch

    def branch(state: DistState, indices: Indices) -> DistState:
        qu = state.queues[li]
        W, (wprefix, wk, wweight), valid = _window(
            [qu.prefix, qu.k, qu.weight], qu.size, B)

        qks, min_i, min_c, count_ok, recv_load = _remote_counts(
            lv, dcfg, indices, wprefix, valid, state.recv_load, mesh)
        remaining = torch.where(valid & count_ok,
                                torch.clamp(min_c - wk, min=0), 0)
        allowed, aacum = _budget(remaining, B)
        r, k_off, pvalid = _expand(aacum, allowed, wk, B)

        new_prefix, alive, incomplete, n_isect, recv_load = \
            _propose_intersect(lv, dcfg, indices, wprefix, min_i, r, k_off,
                               pvalid, recv_load, qks, mesh)
        weight = _rows(wweight, r)

        # rem-ext deferral: advance each prefix past its last complete
        # contiguous proposal only; later survivors retry next round
        inc_off = torch.where(incomplete, k_off, INF)
        first_inc = _segment_min(inc_off, r, W)
        advance = _clip(torch.minimum(first_inc, wk + allowed) - wk, 0,
                        allowed)
        consumed = valid & count_ok & (wk + advance >= min_c)
        before = k_off < _rows(first_inc, r)
        alive = alive & before
        n_proposed = (pvalid & before).sum(1)

        # retire consumed prefixes (identical to the single-host branch)
        (pfx, kk, ww), nsz = _retire([qu.prefix, qu.k, qu.weight], qu.size,
                                     W, consumed, 1, wk + advance)
        queues = list(state.queues)
        queues[li] = LevelQueue(pfx, kk, ww, nsz)
        queues, out_buf, out_weight, out_n, out_count, overflow = _emit(
            plan, dcfg.base, li, state, queues, new_prefix, weight, alive)
        return DistState(queues, out_buf, out_weight, out_n, out_count,
                         overflow, state.proposals + n_proposed,
                         state.intersections + n_isect, recv_load)

    return branch


def build_dist_step(plan: Plan, dcfg: DistConfig,
                    mesh: WorkerMesh):
    """``step((state, pieces), indices, qsizes, psizes)``: one lock-step
    dataflow step.  Workers must agree on the branch (they all take part
    in its exchanges), so it is chosen from the queue sizes summed over
    every worker of the mesh (``qsizes``; ``psizes`` the piece queues'
    under balance): the globally deepest non-empty level."""
    if dcfg.balance:
        from repro_torch.core.balance import build_balanced_step
        return build_balanced_step(plan, dcfg, mesh)
    branches = [_build_dist_level(plan, dcfg, li, mesh)
                for li in range(len(plan.levels))]

    def step(carry, indices, qsizes, psizes):
        state, pieces = carry
        nz = [i for i, s in enumerate(qsizes) if s > 0]
        deepest = nz[-1] if nz else len(branches) - 1
        return branches[deepest](state, indices), pieces

    return step


# ---------------------------------------------------------------------------
# the whole join: seed -> drain -> sum over the workers
# ---------------------------------------------------------------------------

def build_per_worker(plan: Plan, dcfg: DistConfig, step_hook=None, *,
                     mesh: WorkerMesh):
    """The dataflow of the workers ``mesh``'s rank holds: ``fn(indices,
    seed [wl,S,width], seed_n [wl], seed_w [wl,S])`` -> (count,
    proposals, intersections, steps, overflow, max_load, sum_load[,
    out_buf, out_weight, out_n]), the numbers host ints over the whole
    mesh, the same on every rank (the rank's output rows as tensors).  ``seed_w`` carries signed seed
    weights (+1/-1).  ``step_hook(i, run)``, when given, makes step ``i``
    by calling ``run()`` and returning its result (a profiler's window
    around one step)."""
    step = build_dist_step(plan, dcfg, mesh)
    w, cap = dcfg.num_workers, dcfg.route_capacity
    collect = dcfg.base.mode == "collect"
    perm = list(np.argsort(np.asarray(plan.attr_order)))

    def per_worker(indices: Indices, seed: torch.Tensor,
                   seed_n: torch.Tensor, seed_w: torch.Tensor):
        dev = seed.device
        wl, S = seed.shape[:2]
        state = make_state(plan, dcfg.base, wl, dev, seed_capacity=S)

        # seed enqueue behind the remote seed filters
        alive = torch.arange(S, dtype=torch.int32, device=dev) < \
            seed_n[:, None]
        bound = tuple(plan.attr_order[:plan.seed_width])
        route_ovf = torch.zeros(wl, dtype=torch.int32, device=dev)
        for b in plan.seed_filters:
            idx = indices[b.index_id]
            qk = _binding_key(seed, bound, b.key_attrs, idx)
            qv = seed[..., bound.index(b.ext_attr)]
            mem, _, ok, _ld = _remote_member(
                idx, qk, qv, owner_of(qk, w), alive, w,
                max(cap, S // max(w // 2, 1) + 1), dcfg.aggregate, mesh)
            # a seed whose route slot overflowed got NO reply; dropping it
            # would silently undercount, so flag OVF_ROUTE and escalate
            route_ovf = route_ovf | torch.where(
                (alive & ~ok).any(1), OVF_ROUTE, 0).to(torch.int32)
            alive = alive & mem & ok
        for f in plan.seed_ineq:
            alive = alive & (seed[..., bound.index(f.lo)]
                             < seed[..., bound.index(f.hi)])
        state.overflow = state.overflow | route_ovf
        wts = seed_w.to(torch.int32)
        steps = 0
        pieces = ()
        if not plan.levels:
            # the seed covers every attribute: filtered seeds ARE the
            # outputs; nothing to drain
            state.out_count = state.out_count + \
                (wts * alive).sum(1, dtype=torch.int64)
            if collect:
                (state.out_buf, state.out_weight), n_new, ovf = _append(
                    [state.out_buf, state.out_weight], state.out_n,
                    [seed[..., perm], wts], alive)
                state.out_n = torch.clamp(state.out_n + n_new,
                                          max=state.out_buf.shape[1])
                state.overflow = (state.overflow | torch.where(
                    ovf, OVF_OUT, 0)).to(torch.int32)
        else:
            q0 = state.queues[0]
            (npfx, nk, nw), n_new, ovf = _append(
                [q0.prefix, q0.k, q0.weight], q0.size,
                [seed, torch.zeros_like(wts), wts], alive)
            state.queues = (LevelQueue(npfx, nk, nw, q0.size + n_new),) + \
                state.queues[1:]
            state.overflow = (state.overflow | torch.where(
                ovf, OVF_SEED, 0)).to(torch.int32)
            if dcfg.balance:
                from repro_torch.core.balance import make_piece_queues
                pieces = make_piece_queues(plan, dcfg, dev, wl)
            carry = (state, pieces)
            L = len(plan.levels)
            while steps < dcfg.max_steps:
                st, pcs = carry
                # ONE host read a step: every queue's size summed over
                # the mesh's workers (the piece queues' after them), the
                # same on every rank
                sizes = torch.stack([q.size for q in st.queues]
                                    + [p.size for p in pcs])
                g = psum(sizes.T, mesh).tolist()
                if not any(s > 0 for s in g):
                    break
                if step_hook is None:
                    carry = step(carry, indices, g[:L], g[L:])
                else:
                    carry = step_hook(steps, lambda c=carry: step(
                        c, indices, g[:L], g[L:]))
                steps += 1
            state, pieces = carry

        # the counters and the overflow kinds in one sum over the mesh;
        # per-bit sums, so distinct workers' overflow kinds OR (not add)
        shifts = torch.arange(len(_KIND_BITS), dtype=torch.int32,
                              device=dev)
        tot = psum(torch.cat([
            torch.stack([state.out_count, state.proposals,
                         state.intersections, state.recv_load], 1),
            ((state.overflow[:, None] >> shifts) & 1).to(torch.int64)], 1),
            mesh).tolist()
        ovf = sum(1 << i for i, b in enumerate(tot[4:]) if b > 0)
        outs = (tot[0], tot[1], tot[2], steps, ovf,
                int(pmax(state.recv_load, mesh)), tot[3])
        if collect:
            outs = outs + (state.out_buf, state.out_weight, state.out_n)
        return outs

    return per_worker


@dataclasses.dataclass
class DistJoinResult:
    count: int
    proposals: int
    intersections: int
    steps: int
    max_load: int = 0  # max over workers of requests served (Thm 3.4)
    mean_load: float = 0.0
    tuples: Optional[np.ndarray] = None  # every worker's rows, in order
    weights: Optional[np.ndarray] = None
    worker_rows: Optional[np.ndarray] = None  # [w] rows of each worker


def distributed_join(plan: Plan, relations: Dict[str, np.ndarray],
                     mesh: Optional[WorkerMesh] = None,
                     cfg: Optional[DistConfig] = None,
                     device=None, *, indices: Optional[Indices] = None,
                     step_hook=None) -> DistJoinResult:
    """End-to-end distributed static join of ``relations`` on the
    workers of ``mesh`` (default: ``cfg.num_workers`` workers, one
    without a config, on ``device``; ``None``: the card, see
    ``csr.resolve_device``).  The seeds are dealt to the workers in
    contiguous blocks.  ``indices`` reuses a :func:`partition_indices`
    of the same relations and mesh; ``step_hook`` is
    ``build_per_worker``'s.  On a mesh of R ranks every rank calls it
    with the same relations, runs its workers' blocks and returns the
    same result: the whole mesh's numbers and rows.  Raises
    ``CapacityOverflow`` when a buffer overflowed anywhere."""
    if mesh is None:
        mesh = make_host_mesh(cfg.num_workers if cfg is not None else 1,
                              device)
    elif device is not None and torch.device(device) != \
            torch.device(mesh.device):
        raise ValueError(f"device {device} is not the mesh's "
                         f"{mesh.device}")
    w = mesh.num_workers
    dev = torch.device(mesh.device)
    if cfg is None:
        base = BigJoinConfig(batch=1024, mode="count")
        cfg = DistConfig(base, w, route_capacity=max(1024 // w, 16) * 4)
    if cfg.num_workers != w:
        raise ValueError(f"config for {cfg.num_workers} workers on a mesh "
                         f"of {w}")
    if indices is None:
        indices = partition_indices(plan, relations, w, device=dev,
                                    mesh=mesh)
    seed = seed_tuples_for(plan, relations)
    sw = plan.seed_width
    n = seed.shape[0]
    per = -(-n // w)
    pad = np.zeros((per * w - n, sw), np.int32)
    chunks = np.concatenate([seed, pad]).reshape(w, per, sw)
    # the real seeds of each block: the JAX package gives the last block
    # ``per - pad``, which with fewer than w² seeds counts padding rows of
    # the block before it as seeds (ROADMAP Queue 3); equal otherwise
    seed_n = np.clip(n - per * np.arange(w), 0, per).astype(np.int32)
    lo, hi = mesh.span
    out = build_per_worker(plan, cfg, step_hook, mesh=mesh)(
        indices, torch.from_numpy(chunks[lo:hi]).to(dev),
        torch.from_numpy(seed_n[lo:hi]).to(dev),
        torch.ones((hi - lo, per), dtype=torch.int32, device=dev))
    if out[4]:
        raise CapacityOverflow(out[4], where="distributed static join")
    res = DistJoinResult(out[0], out[1], out[2], out[3], out[5],
                         float(out[6]) / w)
    if cfg.base.mode == "collect":
        res.worker_rows, (res.tuples, res.weights) = gather_rows(
            out[9], (out[7], out[8]), mesh)
    return res


# ---------------------------------------------------------------------------
# the compiled-program cache: one program a (plan, config, mesh)
# ---------------------------------------------------------------------------

class DistributedProgram:
    """One whole-join dataflow of the rank's workers for one (plan,
    config, mesh): ``program(indices, seed [wl,S,width], seed_n [wl],
    seed_w [wl,S])`` -> (count, proposals, intersections, steps, overflow,
    max_load, sum_load[, out_buf, out_weight, out_n]),
    ``build_per_worker``'s.  The
    JAX package's program is a jitted ``shard_map`` with an AOT ``warm``;
    here it is the eager dataflow, built once and reused, and nothing is
    compiled per shape, so it has no ``warm``."""

    def __init__(self, plan: Plan, dcfg: "DistConfig", mesh: WorkerMesh):
        if dcfg.num_workers != mesh.num_workers:
            raise ValueError(f"config for {dcfg.num_workers} workers on a "
                             f"mesh of {mesh.num_workers}")
        self._per_worker = build_per_worker(plan, dcfg, mesh=mesh)
        self.mesh = mesh
        self.w = dcfg.num_workers

    def __call__(self, indices, seed, seed_n, seed_w):
        return self._per_worker(indices, seed, seed_n, seed_w)


def build_distributed_program(plan: Plan, dcfg: "DistConfig",
                              mesh: WorkerMesh) -> DistributedProgram:
    """Build one :class:`DistributedProgram` (the public constructor)."""
    return DistributedProgram(plan, dcfg, mesh)


_PROGRAM_CACHE: Dict[tuple, DistributedProgram] = {}
_PROGRAM_BUILDS = 0  # monotonic build counter (cache-hit assertions)


def get_distributed_program(plan: Plan, dcfg: "DistConfig",
                            mesh: WorkerMesh) -> DistributedProgram:
    """The process-wide program cache: plans, configs and meshes hash
    structurally, so every engine and session asking for the same (plan,
    config, mesh) shares one program."""
    global _PROGRAM_BUILDS
    key = (plan, dcfg, mesh)
    prog = _PROGRAM_CACHE.get(key)
    if prog is None:
        _PROGRAM_BUILDS += 1
        prog = build_distributed_program(plan, dcfg, mesh)
        _PROGRAM_CACHE[key] = prog
    return prog


def deal_seed(seed: np.ndarray, weights: np.ndarray, w: int,
              width: int = 2, floor: int = 0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Round-robin deal of a seed batch over ``w`` workers (worker k gets
    rows k, k + w, ...), padded to a pow2 chunk a worker of at least
    ``floor`` rows, so every delta epoch of a stream shares one seed shape.
    ``width`` is the seed prefix width (``plan.seed_width``).  Returns
    (chunks [w, S, width], seed_n [w], weights [w, S]).  Not the contiguous
    blocks of :func:`distributed_join`'s static seeds."""
    seed = np.asarray(seed, np.int32).reshape(-1, width)
    weights = np.asarray(weights, np.int32)
    per = -(-seed.shape[0] // w)
    S = max(_delta._pow2(per), int(floor))
    chunks = np.zeros((w, S, width), np.int32)
    wchunks = np.zeros((w, S), np.int32)
    seed_n = np.zeros(w, np.int32)
    for k in range(w):
        rows = seed[k::w]
        chunks[k, :rows.shape[0]] = rows
        wchunks[k, :rows.shape[0]] = weights[k::w]
        seed_n[k] = rows.shape[0]
    return chunks, seed_n, wchunks


def run_program(program: DistributedProgram, w: int, collect: bool, indices,
                seed: np.ndarray, weights: np.ndarray, width: int = 2,
                seed_floor: int = 0) -> JoinResult:
    """Deal the seed, run one program, sum the workers' outputs: the
    ``dist.program`` fault point fires first, a non-zero overflow mask
    raises ``CapacityOverflow``, and the collected tuples are every
    worker's rows in worker order.  On a mesh of R ranks every rank
    deals the same batch and runs its workers' rows of it; the overflow
    mask and the rows are the whole mesh's, so every rank returns (or
    raises) the same."""
    faults.fire("dist.program")
    chunks, seed_n, wchunks = deal_seed(seed, weights, w, width,
                                        floor=seed_floor)
    mesh = program.mesh
    lo, hi = mesh.span
    dev = torch.device(mesh.device)
    out = program(indices, torch.from_numpy(chunks[lo:hi]).to(dev),
                  torch.from_numpy(seed_n[lo:hi]).to(dev),
                  torch.from_numpy(wchunks[lo:hi]).to(dev))
    if out[4]:
        raise CapacityOverflow(out[4], where="distributed join",
                               detail=f"w={w} seed_floor={seed_floor}")
    tuples = wts = None
    if collect:
        _, (tuples, wts) = gather_rows(out[9], (out[7], out[8]), mesh)
    return JoinResult(out[0], tuples, wts, out[1], out[2], out[3])


# ---------------------------------------------------------------------------
# Distributed Delta-BiGJoin (§4): streaming maintenance on the mesh
# ---------------------------------------------------------------------------

def default_delta_config(w: int, batch: int = 1024, mode: str = "collect",
                         out_capacity: int = 1 << 18,
                         balance: bool = False) -> DistConfig:
    """A DistConfig sized for delta workloads: route capacity
    ``max(4·batch // w, 64)`` a peer pair (the deferral backpressure keeps
    the result exact when it overflows)."""
    base = BigJoinConfig(batch=batch, seed_chunk=batch, mode=mode,
                         out_capacity=out_capacity)
    return DistConfig(base, w, route_capacity=max(4 * batch // w, 64),
                      balance=balance)


def make_delta_monitor(query, initial_edges, local: bool = False,
                       batch: int = 2048, out_capacity: int = 1 << 20,
                       balance: bool = False,
                       mesh: Optional[WorkerMesh] = None, device=None):
    """Deprecated: use :class:`repro_torch.api.GraphSession`.  Selects the
    one-device :class:`~repro_torch.core.delta.DeltaBigJoin` or the mesh's
    :class:`DistDeltaBigJoin` with matching B' and output budgets."""
    import warnings
    warnings.warn(
        "make_delta_monitor is deprecated; use repro_torch.api.GraphSession "
        "(register() one or more queries, update() once per epoch)",
        DeprecationWarning, stacklevel=2)
    if local:
        cfg = BigJoinConfig(batch=batch, seed_chunk=batch, mode="collect",
                            out_capacity=out_capacity)
        return _delta.DeltaBigJoin(query, initial_edges, cfg=cfg,
                                   device=device)
    w = DEFAULT_WORKERS if mesh is None else mesh.num_workers
    return DistDeltaBigJoin(
        query, initial_edges, mesh=mesh,
        dcfg=default_delta_config(w, batch=batch, out_capacity=out_capacity,
                                  balance=balance), device=device)


class DistDeltaBigJoin(_delta.DeltaBigJoin):
    """Delta-BiGJoin where every region shard lives on a mesh worker.

    The epoch bookkeeping (normalize, commit, compaction) is the
    one-device engine's; only the worker layout differs:

    - every region is hash-partitioned by packed key over the workers
      (``RegionStore(shard_w=w)``), so each entry has one owner and the
      cluster's memory is O(IN + delta); the commit folds stay
      shard-local (a delta entry and the committed entry it cancels share
      an owner), one launch of the fold kernel's worker axis each;
    - each delta query dAQ_i deals its signed dR batch round-robin over
      the workers and runs the request/response dataflow of §3.4 (with
      BiGJoin-S Balance under ``dcfg.balance``), counts and outputs
      summed over the workers;
    - the per-plan program is built once (the process-wide cache) and
      the seed chunk rides the store's ``("seed", width)`` rung, so every
      epoch of a stream runs one program at one seed shape.

    ``mesh`` defaults to ``dcfg.num_workers`` workers (without a config,
    ``launch.mesh.DEFAULT_WORKERS``) on ``device`` (``None``: the card).
    """

    def __init__(self, query, initial_edges,
                 mesh: Optional[WorkerMesh] = None,
                 dcfg: Optional[DistConfig] = None,
                 compact_ratio: float = 0.5,
                 store: Optional[_delta.RegionStore] = None, device=None):
        if mesh is None:
            if device is None and store is not None:
                device = store.device
            mesh = make_host_mesh(dcfg.num_workers if dcfg is not None
                                  else DEFAULT_WORKERS, device)
        elif device is not None and torch.device(device) != \
                torch.device(mesh.device):
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh
        self.w = mesh.num_workers
        if dcfg is None:
            dcfg = default_delta_config(self.w)
        if dcfg.num_workers != self.w:
            raise ValueError(
                f"dcfg does not match the mesh: {dcfg.num_workers} workers "
                f"vs a mesh of {self.w}")
        if store is not None:
            if store.shard_w != self.w:
                raise ValueError(
                    f"shared store is sharded over {store.shard_w} workers, "
                    f"mesh has {self.w}")
            if store.device != torch.device(mesh.device):
                raise ValueError(f"shared store lives on {store.device}, "
                                 f"the mesh on {mesh.device}")
            if store.mesh.ranks != mesh.ranks:
                raise ValueError(
                    f"shared store is held by {store.mesh.ranks} "
                    f"ranks, the mesh by {mesh.ranks}")
        self.dcfg = dcfg
        self._programs: Dict[int, DistributedProgram] = {}
        super().__init__(query, initial_edges, cfg=dcfg.base,
                         compact_ratio=compact_ratio, store=store,
                         device=mesh.device)

    def _new_store(self, edges, compact_ratio, device):
        return _delta.RegionStore(edges, shard_w=self.w,
                                  compact_ratio=compact_ratio, device=device,
                                  mesh=self.mesh)

    def _program(self, pi: int) -> DistributedProgram:
        if pi not in self._programs:
            self._programs[pi] = get_distributed_program(
                self.plans[pi], self.dcfg, self.mesh)
        return self._programs[pi]

    def _run_plan(self, plan, indices, seed, weights):
        # the per-worker seed chunk rides its own ratcheted rung, so every
        # epoch of a stream runs at one seed shape (prewarm pins the mark
        # at the update-batch bound; the session's static count keeps off
        # this key)
        prog = self._program(self.plans.index(plan))
        width = plan.seed_width
        per = -(-seed.shape[0] // self.w)
        floor = self.store.ratchet.capacity(("seed", width), per)
        return run_program(prog, self.w, self.dcfg.base.mode == "collect",
                           indices, seed, weights, width=width,
                           seed_floor=floor)

    def _escalate(self, exc) -> None:
        """Mesh overflow recovery: grows the per-peer route tables too and
        drops the programs of the old config (the cache keys on it)
        before the replay."""
        qn = self.query.name
        r = self.store.ratchet
        base, dcfg, changed = self.dcfg.base, self.dcfg, False
        if exc.kinds & ESCALATES_OUT:
            new_out = r.escalate(("cap", "out", qn),
                                 floor=base.out_capacity)
            base = dataclasses.replace(base, out_capacity=new_out)
            changed = True
        if exc.kinds & ESCALATES_BATCH:
            new_b = r.escalate(("cap", "batch", qn), floor=base.batch)
            base = dataclasses.replace(
                base, batch=new_b, seed_chunk=max(base.seed_chunk, new_b))
            changed = True
        if exc.kinds & ESCALATES_ROUTE:
            new_rt = r.escalate(("cap", "route", qn),
                                floor=dcfg.route_capacity)
            dcfg = dataclasses.replace(dcfg, route_capacity=new_rt)
            changed = True
        if not changed:
            raise exc
        if base is not self.dcfg.base:
            dcfg = dataclasses.replace(dcfg, base=base)
        self.dcfg = dcfg
        self.cfg = base
        self._programs.clear()
        self.store.stats.escalations += 1

    def prewarm(self, update_batch: int,
                horizon: Optional[int] = None) -> int:
        """The mesh engine's admission prewarm: the one-device engine's
        (probe and delta marks pinned, every kernel library loaded on the
        card), then each delta plan's program built and its
        ``("seed", width)`` mark pinned to the per-worker share of
        ``update_batch``, as the JAX engine's walk pins it.  Returns the
        compile events spent."""
        snap = compilestats.snapshot()
        super().prewarm(update_batch, horizon)
        ub = max(int(update_batch), 1)
        for pi, plan in enumerate(self.plans):
            self._program(pi)
            self.store.ratchet.capacity(("seed", plan.seed_width),
                                        -(-ub // self.w))
        return compilestats.since(snap)
