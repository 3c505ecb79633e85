"""BiGJoin: the paper's dataflow primitive (§3.1) and join driver (§3.2).

Each *step* pops a window of the deepest non-empty prefix queue and pushes
at most ``B'`` proposals through

    count-minimization -> candidate proposal -> intersection

as one fused kernel call (``kernels.extend``), with partially-extended
prefixes resuming via their ``rem-ext`` offset.  Always extending the
deepest level with pending work bounds every queue at O(B') entries
(Lemma 3.1).  Weighted prefixes (+1/-1) make the same dataflow serve
Delta-BiGJoin (``delta.py``).

The host picks the level of each step from the queue sizes it already pulls
to decide whether to continue (the JAX package switches on device); queue
updates happen in place on the state's tensors.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import csr
from repro_torch.core.dataflow_index import VersionedIndex
from repro_torch.core.plan import Plan
from repro_torch.errors import (CapacityOverflow, OVF_OUT, OVF_QUEUE,
                                OVF_SEED)
from repro_torch.kernels.extend.ops import fused_extend

Indices = Dict[str, VersionedIndex]


@dataclasses.dataclass(frozen=True)
class BigJoinConfig:
    """``batch`` is B' — the per-step proposal budget (§3.1.2)."""

    batch: int = 4096
    seed_chunk: int = 4096
    out_capacity: int = 1 << 20
    mode: str = "collect"  # "collect" | "count"

    def queue_capacity(self) -> int:
        return 2 * self.batch

    def __post_init__(self):
        assert self.mode in ("collect", "count")


@dataclasses.dataclass
class LevelQueue:
    prefix: torch.Tensor  # [cap, width] int32
    k: torch.Tensor  # [cap] int32 — next extension offset (rem-ext cursor)
    weight: torch.Tensor  # [cap] int32
    size: torch.Tensor  # [] int32


@dataclasses.dataclass
class BigJoinState:
    queues: Tuple[LevelQueue, ...]  # widths seed_width..m-1
    out_buf: torch.Tensor  # [Ocap, m] int32 (or [1, m] in count mode)
    out_weight: torch.Tensor  # [Ocap] int32
    out_n: torch.Tensor  # [] int32 rows used in out_buf
    out_count: torch.Tensor  # [] int64 weighted output count
    overflow: torch.Tensor  # [] int32 — OVF_* bitmask (repro_torch.errors)
    proposals: torch.Tensor  # [] int64 work counter
    intersections: torch.Tensor  # [] int64 work counter


def make_state(plan: Plan, cfg: BigJoinConfig, device,
               seed_capacity: Optional[int] = None) -> BigJoinState:
    m = plan.query.num_attrs
    sw = plan.seed_width

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    queues = []
    for width in range(sw, m):
        cap = (seed_capacity or cfg.seed_chunk) if width == sw \
            else cfg.queue_capacity()
        queues.append(LevelQueue(zeros(cap, width), zeros(cap), zeros(cap),
                                 zeros()))
    ocap = cfg.out_capacity if cfg.mode == "collect" else 1
    return BigJoinState(tuple(queues), zeros(ocap, m), zeros(ocap), zeros(),
                        zeros(dtype=torch.int64), zeros(),
                        zeros(dtype=torch.int64), zeros(dtype=torch.int64))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _pack_cols(prefix: torch.Tensor, positions: Sequence[int], dtype):
    """Pack prefix columns into a probe key (``csr.pack_key``): one tensor
    cast to the index key dtype, or the (hi, lo) int64 pair for 3-4 bound
    columns (composite indices)."""
    packed = csr.pack_key(tuple(prefix[:, p] for p in positions))
    if isinstance(packed, tuple):
        return packed
    return packed.to(dtype)


def _binding_key(prefix, bound_attrs, key_attrs, idx: VersionedIndex):
    pos = [list(bound_attrs).index(a) for a in key_attrs]
    return _pack_cols(prefix, pos, idx.pos[0].key.dtype)


def _compact(arrays, keep: torch.Tensor):
    """Stable-partition rows with keep=True to the front; returns new size."""
    perm = torch.argsort((~keep).to(torch.int32), stable=True)
    return [a[perm] for a in arrays], keep.sum(dtype=torch.int32)


def _append(dsts, size: torch.Tensor, srcs, alive: torch.Tensor):
    """Append the alive rows of each src to its dst at [size, ...), in
    place (writes past the capacity drop); returns (n_new, overflow)."""
    cap = dsts[0].shape[0]
    a = alive.to(torch.int32)
    cum = torch.cumsum(a, 0, dtype=torch.int32) - a
    dest = torch.where(alive, size + cum, cap)
    n_new = a.sum(dtype=torch.int32)
    ovf = (size + n_new) > cap
    for dst, src in zip(dsts, srcs):
        csr._scatter_drop(dst, dest, src)
    return n_new, ovf


# ---------------------------------------------------------------------------
# the dataflow step
# ---------------------------------------------------------------------------

def _level_branch(plan: Plan, cfg: BigJoinConfig, li: int):
    """The pop -> count-min -> propose -> intersect -> push step of level
    ``li``; the middle is one fused kernel call."""
    lv = plan.levels[li]
    B = cfg.batch
    is_last = li == len(plan.levels) - 1
    new_bound = lv.bound_attrs + (lv.ext_attr,)
    perm = torch.as_tensor(np.argsort(np.asarray(plan.attr_order)))

    def branch(state: BigJoinState, indices: Indices) -> BigJoinState:
        qu = state.queues[li]
        cap = qu.prefix.shape[0]
        W = min(B, cap)
        dev = qu.prefix.device
        wprefix, wk, wweight = qu.prefix[:W], qu.k[:W], qu.weight[:W]
        valid = torch.arange(W, dtype=torch.int32, device=dev) < qu.size

        qks, pos, neg = [], [], []
        for b in lv.bindings:
            idx = indices[b.index_id]
            qks.append(_binding_key(wprefix, lv.bound_attrs, b.key_attrs,
                                    idx))
            pos.append(idx.pos)
            neg.append(idx.neg)
        cand, r, alive, allowed, consumed, counters = fused_extend(
            pos, neg, qks, wk, valid, B)
        rl = r.long()
        new_prefix = torch.cat([wprefix[rl], cand[:, None]], dim=1)
        weight = wweight[rl]
        for f in lv.filters:
            lo = new_prefix[:, list(new_bound).index(f.lo)]
            hi = new_prefix[:, list(new_bound).index(f.hi)]
            alive = alive & (lo < hi)

        # ---- retire consumed prefixes from this queue ---------------------
        kfull = qu.k.clone()
        kfull[:W] = wk + allowed
        live_row = torch.arange(cap, dtype=torch.int32, device=dev) < qu.size
        done = torch.zeros(cap, dtype=torch.bool, device=dev)
        done[:W] = consumed
        (pfx, kk, ww), nsz = _compact([qu.prefix, kfull, qu.weight],
                                      live_row & ~done)
        queues = list(state.queues)
        queues[li] = LevelQueue(pfx, kk, ww, nsz)

        out_n, out_count = state.out_n, state.out_count
        overflow = state.overflow
        if is_last:
            out_count = out_count + (weight * alive).sum(dtype=torch.int64)
            if cfg.mode == "collect":
                rows = new_prefix[:, perm.to(dev)]
                n_new, ovf = _append([state.out_buf, state.out_weight],
                                     out_n, [rows, weight], alive)
                out_n = torch.clamp(out_n + n_new,
                                    max=state.out_buf.shape[0])
                overflow = overflow | torch.where(ovf, OVF_OUT, 0)
        else:
            nxt = queues[li + 1]
            n_new, ovf = _append(
                [nxt.prefix, nxt.k, nxt.weight], nxt.size,
                [new_prefix, torch.zeros(B, dtype=torch.int32, device=dev),
                 weight], alive)
            queues[li + 1] = LevelQueue(
                nxt.prefix, nxt.k, nxt.weight,
                torch.clamp(nxt.size + n_new, max=nxt.prefix.shape[0]))
            overflow = overflow | torch.where(ovf, OVF_QUEUE, 0)

        return BigJoinState(
            tuple(queues), state.out_buf, state.out_weight, out_n,
            out_count, overflow.to(torch.int32),
            state.proposals + counters[0].to(torch.int64),
            state.intersections + counters[1].to(torch.int64))

    return branch


def build_step(plan: Plan, cfg: BigJoinConfig):
    """One scheduler step: extend the deepest non-empty level (§3.2).
    ``sizes`` are the queue sizes the driver pulled for this step."""
    branches = [_level_branch(plan, cfg, li)
                for li in range(len(plan.levels))]

    def step(state: BigJoinState, indices: Indices, sizes) -> BigJoinState:
        if not branches:
            # the seed covers every attribute: nothing to drain
            return state
        nz = [i for i, s in enumerate(sizes) if s > 0]
        deepest = nz[-1] if nz else len(branches) - 1
        return branches[deepest](state, indices)

    return step


def build_seed_step(plan: Plan, cfg: BigJoinConfig):
    """Enqueue a chunk of seed prefixes, applying seed filters (§4.2); a
    seed covering EVERY attribute goes straight to the output."""
    perm = torch.as_tensor(np.argsort(np.asarray(plan.attr_order)))

    def seed_step(state: BigJoinState, indices: Indices,
                  prefixes: torch.Tensor, weights: torch.Tensor,
                  valid: torch.Tensor) -> BigJoinState:
        alive = valid
        bound = tuple(plan.attr_order[:plan.seed_width])
        for b in plan.seed_filters:
            idx = indices[b.index_id]
            qk = _binding_key(prefixes, bound, b.key_attrs, idx)
            qv = prefixes[:, bound.index(b.ext_attr)]
            alive = alive & idx.member(qk, qv)
        for f in plan.seed_ineq:
            alive = alive & (prefixes[:, bound.index(f.lo)]
                             < prefixes[:, bound.index(f.hi)])
        if not plan.levels:  # seed covers all attrs: direct output
            weights = weights.to(torch.int32)
            out_count = state.out_count + (weights * alive).sum(
                dtype=torch.int64)
            out_n, overflow = state.out_n, state.overflow
            if cfg.mode == "collect":
                n_new, ovf = _append(
                    [state.out_buf, state.out_weight], out_n,
                    [prefixes[:, perm.to(prefixes.device)], weights], alive)
                out_n = torch.clamp(out_n + n_new,
                                    max=state.out_buf.shape[0])
                overflow = (overflow | torch.where(ovf, OVF_OUT, 0)
                            ).to(torch.int32)
            return dataclasses.replace(state, out_n=out_n,
                                       out_count=out_count,
                                       overflow=overflow)
        q0 = state.queues[0]
        n_new, ovf = _append(
            [q0.prefix, q0.k, q0.weight], q0.size,
            [prefixes, torch.zeros(prefixes.shape[0], dtype=torch.int32,
                                   device=prefixes.device), weights], alive)
        queues = list(state.queues)
        queues[0] = LevelQueue(q0.prefix, q0.k, q0.weight,
                               torch.clamp(q0.size + n_new,
                                           max=q0.prefix.shape[0]))
        return dataclasses.replace(
            state, queues=tuple(queues),
            overflow=(state.overflow | torch.where(ovf, OVF_SEED, 0)
                      ).to(torch.int32))

    return seed_step


@functools.lru_cache(maxsize=64)
def _compiled_fns(plan: Plan, cfg: BigJoinConfig):
    return build_step(plan, cfg), build_seed_step(plan, cfg)


@dataclasses.dataclass
class JoinResult:
    count: int  # weighted output count
    tuples: Optional[np.ndarray]  # [N, m] in attribute order (collect mode)
    weights: Optional[np.ndarray]
    proposals: int
    intersections: int
    steps: int


def _device_of(indices: Indices) -> torch.device:
    for vi in indices.values():
        return vi.pos[0].device
    return csr.resolve_device(None)


def run_bigjoin(plan: Plan, indices: Indices, seed: np.ndarray,
                weights: Optional[np.ndarray] = None,
                cfg: BigJoinConfig = BigJoinConfig(),
                device=None) -> JoinResult:
    """Host driver: feed seed chunks, drain the dataflow to completion.
    Runs on the device of the indices (or ``device``)."""
    dev = torch.device(device) if device is not None else \
        _device_of(indices)
    step, seed_step = _compiled_fns(plan, cfg)
    state = make_state(plan, cfg, dev)
    seed = np.asarray(seed, np.int32).reshape(-1, plan.seed_width)
    if weights is None:
        weights = np.ones(seed.shape[0], np.int32)
    weights = np.asarray(weights, np.int32)
    S = cfg.seed_chunk
    nsteps = 0
    for lo in range(0, max(seed.shape[0], 1), S):
        chunk = seed[lo:lo + S]
        wchunk = weights[lo:lo + S]
        n = chunk.shape[0]
        if n == 0:
            continue
        pad = S - n
        chunk = np.pad(chunk, ((0, pad), (0, 0)))
        wchunk = np.pad(wchunk, (0, pad))
        vmask = np.arange(S) < n
        state = seed_step(state, indices, torch.from_numpy(chunk).to(dev),
                          torch.from_numpy(wchunk).to(dev),
                          torch.from_numpy(vmask).to(dev))
        while True:
            sizes = torch.stack([q.size for q in state.queues]).tolist() \
                if state.queues else []
            if not any(s > 0 for s in sizes):
                break
            state = step(state, indices, sizes)
            nsteps += 1
    mask = int(state.overflow)
    if mask:
        raise CapacityOverflow(
            mask, where="local bigjoin",
            detail=f"batch={cfg.batch} out_capacity={cfg.out_capacity}")
    tuples = wts = None
    if cfg.mode == "collect":
        n = int(state.out_n)
        tuples = state.out_buf[:n].cpu().numpy()
        wts = state.out_weight[:n].cpu().numpy()
    return JoinResult(int(state.out_count), tuples, wts,
                      int(state.proposals), int(state.intersections), nsteps)


def build_indices(plan: Plan, relations: Dict[str, np.ndarray],
                  capacity_slack: float = 1.0, device=None) -> Indices:
    """Static VersionedIndex per plan index id (version 'static' only), on
    ``device`` (``None``: the card, see :func:`csr.resolve_device`)."""
    device = csr.resolve_device(device)
    out: Indices = {}
    for index_id, rel, key_pos, ext_pos, version in plan.index_ids():
        if version != "static":
            raise ValueError("use delta.RegionStore for delta plans")
        tuples = np.asarray(relations[rel])
        cap = max(int(tuples.shape[0] * capacity_slack), 1)
        out[index_id] = VersionedIndex.static(
            csr.build_index(tuples, key_pos, ext_pos, cap, device=device))
    return out


def seed_tuples_for(plan: Plan, relations: Dict[str, np.ndarray]
                    ) -> np.ndarray:
    rel = np.asarray(relations[plan.query.atoms[plan.seed_atom].rel])
    return np.unique(rel[:, list(plan.seed_cols)], axis=0).astype(np.int32)
