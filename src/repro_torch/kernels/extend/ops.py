"""The fused BiGJoin extension step.

Replaces the TPU kernel ``src/repro/kernels/extend/extend.py``
(``make_extend_kernel`` / ``_extend_call``, reached through
``ops.fused_extend``), 1-word and composite (hi, lo) bindings.  The CUDA
kernel is
``csrc/extend.cu``: count-minimization per window row, one block for the
budget scans, then one thread per proposal for gather and signed
intersection; it is bound by the scattered reads of its binary searches
(see the source note there).  ``ref.fused_extend_ref`` is its plain
version.
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
    qks = tuple(cast)
    if not wk.is_cuda:
        return fused_extend_ref(pos, neg, qks, wk, valid, batch)
    return _launch(pos, neg, qks, wk, valid, int(batch))


def _launch(pos, neg, qks, wk, valid, B):
    nb = len(pos)
    if not 1 <= nb <= MAX_BINDINGS:
        raise ValueError(f"1..{MAX_BINDINGS} bindings per level, got {nb}")
    regions, bind, keep = [], [], []
    composite = False
    for p, n, q in zip(pos, neg, qks):
        if not p or len(p) + len(n) > MAX_REGIONS:
            raise ValueError("1..8 regions per binding, positives first")
        qh, ql = (q if isinstance(q, tuple) else (q, None))
        qh = qh.contiguous()
        ql = None if ql is None else ql.contiguous()
        keep += [qh] + ([] if ql is None else [ql])
        composite |= ql is not None
        regions += list(p) + list(n)
        bind += [len(p), len(n), int(qh.dtype == torch.int64),
                 _build.ptr(qh), _build.ptr(ql)]
    wk = wk.to(torch.int32).contiguous()
    valid = valid.to(torch.int32).contiguous()
    _build.require_cuda(wk, valid, *keep)
    W = wk.shape[0]
    dev = wk.device
    lib = _build.lib("extend")
    # scratch and every output in one allocation (one call where seven
    # cost the host a few microseconds each, on every BiGJoin step)
    sizes = [lib.repro_extend_scratch(nb, W), B, B, B, W, W, 2]
    scratch, cand, row, alive, allowed, consumed, counters = torch.empty(
        sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    p = _build.ptr
    rc = lib.repro_extend(
        _build.region_desc(regions), _build.int_array(bind), nb, W, B,
        p(wk), p(valid), p(scratch), p(cand), p(row), p(alive), p(allowed),
        p(consumed), p(counters), _build.stream_of(wk))
    _build.check("extend", rc)
    count_launch("fused_extend_lex" if composite else "fused_extend")
    return cand, row, alive > 0, allowed, consumed > 0, counters
