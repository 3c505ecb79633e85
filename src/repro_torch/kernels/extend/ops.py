"""The fused BiGJoin extension step.

Replaces the TPU kernel ``src/repro/kernels/extend/extend.py``
(``make_extend_kernel`` / ``_extend_call``, reached through
``ops.fused_extend``), 1-word and composite (hi, lo) bindings.  The CUDA
kernel is ``csrc/extend.cu``: one cooperative launch a call, whose phases
(range searches and count-minimization over the window, the budget scans
and the expansion of rows into proposal slots, gather and signed
intersection) meet at grid-wide barriers; it is bound by the chains of
dependent loads of its searches (see the source note there).  It reads
``valid`` and writes ``alive`` and ``consumed`` as bool, so a call makes
no other launch.  ``ref.fused_extend_ref`` is its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.extend.ref import fused_extend_ref

MAX_BINDINGS = 8  # REPRO_MAX_BINDINGS in csrc/extend.cu
MAX_REGIONS = 8  # REPRO_MAX_REGIONS in csrc/common.cuh


def fused_extend(pos, neg, qks, wk, valid, batch: int):
    """Run one extension step of a plan level.

    pos/neg: per-binding tuples of sorted regions (``key``/``val``/``n``,
    and ``lo`` when the binding keys on 3-4 columns); qks: per-binding
    packed lookup keys [W] — one tensor, or a (hi, lo) pair for a
    composite binding; wk: rem-ext cursors [W]; valid: live-row mask [W];
    batch: the proposal budget B'.

    Returns (cand [B] int32, row [B] int32, alive [B] bool, allowed [W]
    int32, consumed [W] bool, counters [2] int32 = (proposed,
    intersections)).
    """
    if wk.is_cuda:
        return _launch(pos, neg, qks, wk, valid, int(batch))
    pos = tuple(tuple(p) for p in pos)
    neg = tuple(tuple(n) for n in neg)
    # each binding compares in the promoted dtype of its queries and keys
    cast = []
    for q, p, n in zip(qks, pos, neg):
        comp = isinstance(q, tuple)
        if _build.uniform_lo(p + n) != comp:
            raise ValueError("a composite binding takes (hi, lo) keys over "
                             "composite regions")
        qh = q[0] if comp else q
        qh = qh.to(torch.int64 if qh.dtype == torch.int64 or any(
            r.key.dtype == torch.int64 for r in p + n) else torch.int32)
        cast.append((qh, q[1].to(torch.int64)) if comp else qh)
    return fused_extend_ref(pos, neg, tuple(cast), wk, valid, batch)


def _launch(pos, neg, qks, wk, valid, B):
    """The kernel's launch, on the host's shortest path (a BiGJoin epoch
    makes thousands): the kernel compares every key promoted to int64, so
    lookup keys of either width go as they are; it refuses (invalid
    argument) a binding whose regions and keys disagree on the composite
    layout."""
    nb = len(pos)
    if not 1 <= nb <= MAX_BINDINGS:
        raise ValueError(f"1..{MAX_BINDINGS} bindings per level, got {nb}")
    regions, bind, keep = [], [], []
    composite = False
    for p, n, q in zip(pos, neg, qks):
        if not p or len(p) + len(n) > MAX_REGIONS:
            raise ValueError("1..8 regions per binding, positives first")
        if isinstance(q, tuple):
            qh, ql = q
            if ql.dtype != torch.int64:
                ql = ql.to(torch.int64)
            ql = ql.contiguous()
            keep.append(ql)
            composite = True
        else:
            qh, ql = q, None
        if qh.dtype != torch.int32 and qh.dtype != torch.int64:
            qh = qh.to(torch.int64)
        qh = qh.contiguous()
        keep.append(qh)
        regions += p
        regions += n
        bind += (len(p), len(n), qh.dtype == torch.int64, qh.data_ptr(),
                 0 if ql is None else ql.data_ptr())
    if wk.dtype != torch.int32:
        wk = wk.to(torch.int32)
    if valid.dtype != torch.bool:
        valid = valid != 0
    wk, valid = wk.contiguous(), valid.contiguous()
    _build.require_cuda(wk, valid, *keep)
    W = wk.shape[0]
    lib = _build.lib("extend")
    nsc = lib.repro_extend_scratch(len(regions), W)
    # scratch and every output in one allocation; the bool outputs are
    # bytes at its end
    o_row = nsc + B
    o_allowed = o_row + B
    o_counters = o_allowed + W
    o_alive = o_counters + 2
    o_consumed = o_alive + -(-B // 4)
    buf = torch.empty(o_consumed + -(-W // 4), dtype=torch.int32,
                      device=wk.device)
    cand, row = buf[nsc:o_row], buf[o_row:o_allowed]
    allowed, counters = buf[o_allowed:o_counters], buf[o_counters:o_alive]
    alive = buf[o_alive:o_consumed].view(torch.bool)[:B]
    consumed = buf[o_consumed:].view(torch.bool)[:W]
    rc = lib.repro_extend(
        _build.region_desc(regions), _build.int_array(bind), nb, W, B,
        wk.data_ptr(), valid.data_ptr(), buf.data_ptr(), cand.data_ptr(),
        row.data_ptr(), alive.data_ptr(), allowed.data_ptr(),
        consumed.data_ptr(), counters.data_ptr(), _build.stream_of(wk))
    _build.check("extend", rc)
    count_launch("fused_extend_lex" if composite else "fused_extend")
    return cand, row, alive, allowed, consumed, counters
