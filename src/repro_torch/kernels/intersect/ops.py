"""Sorted-region membership: every region of a versioned index in one
launch (``signed_member``), and one region alone (``member``).

``signed_member`` replaces the TPU kernel
``src/repro/kernels/intersect/intersect.py`` (``_make_multi_member_kernel``
/ ``_multi_member_call``, reached through ``ops.signed_member``);
``member`` replaces ``member_kernel`` / ``member_kernel_lex`` /
``_member_call`` (reached through ``ops.member``), both with 1-word and
composite (hi, lo) keys.  One CUDA kernel serves both,
``csrc/intersect.cu``; ``member`` launches it with one positive region and
no negative one and has it write the bits ``wpos > 0``.

What bounds the kernel is the chain of dependent loads of each search, not
the bytes it moves (those stay the row's ``bound_ms``): a thread bisecting
a 2^24-entry region waits on ~24 loads in turn.  The kernel puts a group
of 16, 8 or 4 lanes on each (query, region) pair, searches (L+1)-ary with a
ballot over L pivots a step, stages each region's first-level pivots in
shared memory once per block, and adds the hits in region order (see the
source note there).  The wrapper keeps its host cost low: a descriptor
cached under the values it is built from (``_build.region_desc``), one
output allocation, no dtype conversion that would not change the tensor.
``ref.signed_member_ref`` and ``ref.member_ref`` are the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.csr import IndexData
from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.intersect.ref import member_ref, signed_member_ref

MAX_REGIONS = 8  # REPRO_MAX_REGIONS in csrc/common.cuh


def _key_dtype(regions) -> torch.dtype:
    """The regions' common key dtype (queries are cast to it, as the
    reference kernel wrapper does)."""
    for r in regions:
        if r.key.dtype == torch.int64:
            return torch.int64
    return torch.int32


def signed_member(pos, neg, qk, qv: torch.Tensor):
    """(wpos, wneg) int32 [B]: hit counts of each (qk, qv) over the
    positive / negative regions (objects with ``key``/``val``/``n`` and,
    composite, ``lo``); ``qk`` is one tensor, or the (hi, lo) pair for
    composite regions.  Membership is ``wpos - wneg > 0``, deletion
    ``wneg > 0``."""
    regions = tuple(pos) + tuple(neg)
    ql = None
    if isinstance(qk, tuple):
        qk, ql = qk
        ql = _as(ql, torch.int64)
    if not regions:
        z = torch.zeros(qk.shape, dtype=torch.int32, device=qk.device)
        return z, z
    if _build.uniform_lo(regions) != (ql is not None):
        raise ValueError("composite regions take (hi, lo) queries and "
                         "1-word regions one key")
    qk = _as(qk, _key_dtype(regions))
    qv = _as(qv, torch.int32)
    if not qk.is_cuda:
        return signed_member_ref(pos, neg, qk if ql is None else (qk, ql),
                                 qv)
    return _launch(regions, len(pos), qk, ql, qv, "signed_member")


def member(keys, vals, n, qk, qv: torch.Tensor, los=None, ql=None
           ) -> torch.Tensor:
    """[B] bool: is (qk[, ql], qv) among the first ``n`` live entries of
    the one sorted region (keys[, los], vals)?  Pass the region's ``los``
    word and the queries' ``ql`` word for composite (hi, lo) keys."""
    if (los is None) != (ql is None):
        raise ValueError("composite regions take (hi, lo) queries and "
                         "1-word regions one key")
    qk = _as(qk, keys.dtype)
    qv = _as(qv, torch.int32)
    if ql is not None:
        ql = _as(ql, torch.int64)
    if not qk.is_cuda:
        return member_ref(keys, vals, n, qk, qv, los=los, ql=ql)
    if not isinstance(n, torch.Tensor) or n.dtype != torch.int32 \
            or n.dim() or n.device != keys.device:
        n = torch.as_tensor(n, dtype=torch.int32,
                            device=keys.device).reshape(())
    return _launch((IndexData(keys, vals, n, los),), 1, qk, ql, qv,
                   "member", bits=True)


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, without a call when it already is."""
    return t if t.dtype == dtype else t.to(dtype)


def _launch(regions, npos, qk, ql, qv, name, bits=False):
    if len(regions) > MAX_REGIONS:
        raise ValueError(f"at most {MAX_REGIONS} regions per launch")
    qk, qv = qk.contiguous(), qv.contiguous()
    _build.require_cuda(qk, qv)
    if ql is not None:
        ql = ql.contiguous()
        _build.require_cuda(ql)
    desc = _build.region_desc(regions)
    B = qk.shape[0]
    out = torch.empty(B if bits else (2, B),
                      dtype=torch.bool if bits else torch.int32,
                      device=qk.device)
    lib = _build.lib("intersect")
    p = _build.ptr
    rc = lib.repro_signed_member(
        desc, npos, len(regions), p(qk), int(qk.dtype == torch.int64),
        p(ql), p(qv), B, int(bits), p(out), _build.stream_of(qk))
    _build.check("intersect", rc)
    count_launch(name if ql is None else f"{name}_lex")
    return out if bits else out.unbind()
