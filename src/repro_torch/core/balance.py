"""BiGJoin-S (§3.4): the Balance operator and piece-draining dataflow.

The skew problem: after count-minimization a few prefixes may own almost
all candidate extensions (a celebrity vertex's adjacency list), so the
worker holding them does almost all proposal and intersection work.
BiGJoin-S splits each prefix's extension range into (p, min-i, start, end)
quadruples and deals equal *work* (not equal prefix counts) to every
worker.

The split is the paper's (§3.4.2): each worker divides its local proposal
work T_l into w contiguous chunks of C_l = ceil(T_l/w) and sends chunk j to
worker j, so every receiver gets Σ_l C_l ≈ T/w work (±1 per sender).  A
chunk intersects at most C_l + 1 prefix rows that carry work, so the
per-peer piece capacity is the static bound B'//w + 2 and the exchange can
never overflow: the balance guarantee holds deterministically.

Received quadruples land in a per-level *piece queue*, drained before any
new balance round fires (deeper level first; within a level, pieces
before prefixes), which bounds the piece queue at one round's worth:
w · (B'//w + 2).  Signed seed weights travel inside each quadruple, so
the same machinery serves signed delta seeds.

As in ``core.distributed``, a rank's workers are the leading [wl] axis of
every tensor, chunk j names global worker j, and the exchange of the
pieces is ``exchange.all_to_all`` over the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.bigjoin import LevelQueue
from repro_torch.core.distributed import (DistConfig, DistState, _append,
                                          _budget, _clip, _emit, _expand,
                                          _propose_intersect,
                                          _remote_counts, _retire, _rows,
                                          _segment_min, _window, INF)
from repro_torch.core.exchange import all_to_all
from repro_torch.core.plan import Plan
from repro_torch.errors import OVF_PIECE
from repro_torch.launch.mesh import WorkerMesh


@dataclasses.dataclass
class PieceQueue:
    """(p, min-i, [kcur, kend), weight) quadruples of one level, every
    field with a leading [wl] axis of the rank's workers."""

    prefix: torch.Tensor  # [wl, cap, width] int32
    mini: torch.Tensor  # [wl, cap] int32
    kcur: torch.Tensor  # [wl, cap] int32
    kend: torch.Tensor  # [wl, cap] int32
    weight: torch.Tensor  # [wl, cap] int32
    size: torch.Tensor  # [wl] int32


def piece_caps(dcfg: DistConfig) -> Tuple[int, int]:
    """(per-peer-pair send capacity, piece queue capacity)."""
    w, B = dcfg.num_workers, dcfg.base.batch
    cap_pair = B // w + 2
    return cap_pair, 2 * w * cap_pair


def make_piece_queues(plan: Plan, dcfg: DistConfig, device, wl: int
                      ) -> Tuple[PieceQueue, ...]:
    """Empty piece queues of ``wl`` workers (a rank's)."""
    _, qcap = piece_caps(dcfg)

    def zeros(*shape):
        return torch.zeros((wl,) + shape, dtype=torch.int32, device=device)

    return tuple(
        PieceQueue(zeros(qcap, len(lv.bound_attrs)), zeros(qcap),
                   zeros(qcap), zeros(qcap), zeros(qcap), zeros())
        for lv in plan.levels)


def _exchange(x: torch.Tensor, mesh: WorkerMesh) -> torch.Tensor:
    """[wl_src, w_dst, cap_pair, ...] pieces -> [wl_dst, w_src, cap_pair,
    ...] received ones, through ``exchange.all_to_all``."""
    wl = x.shape[0]
    return all_to_all(x.reshape((wl, -1) + x.shape[3:]), mesh) \
        .reshape(x.shape)


# ---------------------------------------------------------------------------
# prefix branch with Balance (replaces proposal/intersect by piece routing)
# ---------------------------------------------------------------------------

def _build_balance_prefix_branch(plan: Plan, dcfg: DistConfig, li: int,
                                 mesh: WorkerMesh):
    lv = plan.levels[li]
    w, B = dcfg.num_workers, dcfg.base.batch
    cap_pair, _ = piece_caps(dcfg)
    width = len(lv.bound_attrs)

    def branch(carry, indices):
        state, pieces = carry
        qu = state.queues[li]
        dev = qu.prefix.device
        wl = qu.prefix.shape[0]
        W, (wprefix, wk, wweight), valid = _window(
            [qu.prefix, qu.k, qu.weight], qu.size, B)

        # remote count minimization (identical to the unbalanced branch)
        _, min_i, min_c, count_ok, recv_load = _remote_counts(
            lv, dcfg, indices, wprefix, valid, state.recv_load, mesh)
        remaining = torch.where(valid & count_ok,
                                torch.clamp(min_c - wk, min=0), 0)
        allowed, aacum = _budget(remaining, B)  # end offsets
        loff = aacum - allowed  # start offsets
        T_l = aacum[:, -1:]  # [wl, 1]
        C = (T_l + w - 1) // w  # my chunk size (work per receiver)

        # ---- Balance (§3.4.2): chunk j of my work goes to (global)
        # worker j ----------------------------------------------------------
        # A chunk of C units covers at most C + 1 rows WITH work; rows
        # without any (no extension, deferred counts) may lie between
        # them, so the chunk's rows are found among the rows with work,
        # kept in order (``work_rows``).  The JAX package walks every row
        # from the chunk's first, and a chunk spanning more than
        # cap_pair rows loses the rest of its work (ROADMAP Queue 3); where
        # no chunk does, both send the same pieces in the same order.
        has = allowed > 0
        n_work = has.sum(1, dtype=torch.int32)[:, None, None]  # [wl, 1, 1]
        work_rows = torch.argsort((~has).to(torch.int32), dim=1,
                                  stable=True).to(torch.int32)
        acc_w = torch.where(has, aacum, T_l)  # nondecreasing once sorted
        acc_w = _rows(acc_w, work_rows)
        j = torch.arange(w, dtype=torch.int32, device=dev)[None, :, None]
        p = torch.arange(cap_pair, dtype=torch.int32,
                         device=dev)[None, None, :]
        chunk_lo = j * C[:, :, None]  # [wl, w, 1]
        chunk_hi = torch.minimum(chunk_lo + C[:, :, None], T_l[:, :, None])
        rfirst = torch.searchsorted(acc_w, chunk_lo[..., 0].contiguous(),
                                    side="right").to(torch.int32)[..., None]
        slot = rfirst + p  # [wl, w, cap_pair]: the chunk's rows with work
        row = _rows(work_rows, torch.clamp(slot, 0, W - 1))
        lrow, arow = _rows(loff, row), _rows(aacum, row)
        pstart = torch.maximum(lrow, chunk_lo)
        pend = torch.minimum(arow, chunk_hi)
        pvalid = (slot < n_work) & (pstart < pend) & \
            (chunk_lo < T_l[:, :, None])
        kstart = _rows(wk, row) + (pstart - lrow)
        kend = kstart + (pend - pstart)

        # [wl, w, cap_pair, width]
        r_prefix = _exchange(_rows(wprefix, row), mesh)
        r_mini = _exchange(_rows(min_i, row), mesh)
        r_kcur = _exchange(torch.where(pvalid, kstart, 0), mesh)
        r_kend = _exchange(torch.where(pvalid, kend, 0), mesh)
        r_weight = _exchange(_rows(wweight, row), mesh)
        r_valid = _exchange(pvalid.to(torch.int32), mesh) > 0

        # append the received pieces to my piece queue of this level
        pq = pieces[li]
        (npfx, nmini, nkcur, nkend, nwt), n_new, ovf = _append(
            [pq.prefix, pq.mini, pq.kcur, pq.kend, pq.weight], pq.size,
            [r_prefix.reshape(wl, -1, width), r_mini.reshape(wl, -1),
             r_kcur.reshape(wl, -1), r_kend.reshape(wl, -1),
             r_weight.reshape(wl, -1)], r_valid.reshape(wl, -1))
        pieces = list(pieces)
        pieces[li] = PieceQueue(
            npfx, nmini, nkcur, nkend, nwt,
            torch.clamp(pq.size + n_new, max=pq.prefix.shape[1]))

        # retire consumed prefixes (their balanced work now belongs to the
        # receivers; count_ok deferral still applies)
        consumed = valid & count_ok & ((wk + allowed) >= min_c)
        (pfx, kk, ww), nsz = _retire([qu.prefix, qu.k, qu.weight], qu.size,
                                     W, consumed, 1, wk + allowed)
        queues = list(state.queues)
        queues[li] = LevelQueue(pfx, kk, ww, nsz)
        state = dataclasses.replace(
            state, queues=tuple(queues),
            overflow=(state.overflow | torch.where(ovf, OVF_PIECE, 0)
                      ).to(torch.int32),
            recv_load=recv_load)
        return state, tuple(pieces)

    return branch


# ---------------------------------------------------------------------------
# piece-draining branch: Extension-Resolve + Intersect on balanced ranges
# ---------------------------------------------------------------------------

def _build_piece_branch(plan: Plan, dcfg: DistConfig, li: int,
                        mesh: WorkerMesh):
    lv = plan.levels[li]
    B = dcfg.base.batch

    def branch(carry, indices):
        state, pieces = carry
        pq = pieces[li]
        W, (wprefix, wmini, wkcur, wkend, wweight), valid = _window(
            [pq.prefix, pq.mini, pq.kcur, pq.kend, pq.weight], pq.size, B)

        remaining = torch.where(valid, torch.clamp(wkend - wkcur, min=0), 0)
        allowed, aacum = _budget(remaining, B)
        r, k_off, pvalid = _expand(aacum, allowed, wkcur, B)

        new_prefix, alive, incomplete, n_isect, recv_load = \
            _propose_intersect(lv, dcfg, indices, wprefix, wmini, r, k_off,
                               pvalid, state.recv_load, None, mesh)
        weight = _rows(wweight, r)

        inc_off = torch.where(incomplete, k_off, INF)
        first_inc = _segment_min(inc_off, r, W)
        advance = _clip(torch.minimum(first_inc, wkcur + allowed) - wkcur,
                        0, allowed)
        consumed = valid & ((wkcur + advance) >= wkend)
        before = k_off < _rows(first_inc, r)
        alive = alive & before
        n_proposed = (pvalid & before).sum(1)

        (pfx, mini2, kc2, ke2, ww2), nsz = _retire(
            [pq.prefix, pq.mini, pq.kcur, pq.kend, pq.weight], pq.size, W,
            consumed, 2, wkcur + advance)
        pieces = list(pieces)
        pieces[li] = PieceQueue(pfx, mini2, kc2, ke2, ww2, nsz)

        queues, out_buf, out_weight, out_n, out_count, overflow = _emit(
            plan, dcfg.base, li, state, state.queues, new_prefix, weight,
            alive)
        state = DistState(queues, out_buf, out_weight, out_n, out_count,
                          overflow, state.proposals + n_proposed,
                          state.intersections + n_isect, recv_load)
        return state, tuple(pieces)

    return branch


def build_balanced_step(plan: Plan, dcfg: DistConfig,
                        mesh: WorkerMesh):
    """Priority: deepest level first; within a level pieces before
    prefixes.  Branch order: [piece_{L-1}, prefix_{L-1}, ..., piece_0,
    prefix_0]; the step takes the first whose size, summed over every
    worker of the mesh, is non-zero."""
    L = len(plan.levels)
    branches, order = [], []
    for li in reversed(range(L)):
        branches.append(_build_piece_branch(plan, dcfg, li, mesh))
        order.append(("piece", li))
        branches.append(_build_balance_prefix_branch(plan, dcfg, li, mesh))
        order.append(("prefix", li))

    def step(carry, indices, qsizes, psizes):
        gsizes = [psizes[li] if kind == "piece" else qsizes[li]
                  for kind, li in order]
        nz = [i for i, s in enumerate(gsizes) if s > 0]
        sel = nz[0] if nz else 0
        return branches[sel](carry, indices)

    return step
