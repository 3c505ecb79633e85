"""Sorted-region membership: every region of a versioned index in one
launch (``signed_member``), and one region alone (``member``).

``signed_member`` replaces the TPU kernel
``src/repro/kernels/intersect/intersect.py`` (``_make_multi_member_kernel``
/ ``_multi_member_call``, reached through ``ops.signed_member``);
``member`` replaces ``member_kernel`` / ``member_kernel_lex`` /
``_member_call`` (reached through ``ops.member``), both with 1-word and
composite (hi, lo) keys.  One CUDA kernel serves both,
``csrc/intersect.cu``: one thread per query looping over the region
descriptors; ``member`` launches it with one positive region and no
negative one and reads ``wpos > 0``.  It is bound by the scattered reads
of its binary searches (see the source note there).
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
    if any(r.key.dtype == torch.int64 for r in regions):
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
        ql = ql.to(torch.int64)
    if not regions:
        z = torch.zeros(qk.shape, dtype=torch.int32, device=qk.device)
        return z, z
    if _build.uniform_lo(regions) != (ql is not None):
        raise ValueError("composite regions take (hi, lo) queries and "
                         "1-word regions one key")
    qk = qk.to(_key_dtype(regions))
    qv = qv.to(torch.int32)
    if not qk.is_cuda:
        return signed_member_ref(pos, neg, qk if ql is None else (qk, ql),
                                 qv)
    return _launch(tuple(pos), tuple(neg), qk, ql, qv, "signed_member")


def member(keys, vals, n, qk, qv: torch.Tensor, los=None, ql=None
           ) -> torch.Tensor:
    """[B] bool: is (qk[, ql], qv) among the first ``n`` live entries of
    the one sorted region (keys[, los], vals)?  Pass the region's ``los``
    word and the queries' ``ql`` word for composite (hi, lo) keys."""
    if (los is None) != (ql is None):
        raise ValueError("composite regions take (hi, lo) queries and "
                         "1-word regions one key")
    qk = qk.to(keys.dtype)
    qv = qv.to(torch.int32)
    if ql is not None:
        ql = ql.to(torch.int64)
    if not qk.is_cuda:
        return member_ref(keys, vals, n, qk, qv, los=los, ql=ql)
    n = torch.as_tensor(n, dtype=torch.int32, device=keys.device)
    reg = IndexData(keys, vals, n.reshape(()), los)
    wpos, _ = _launch((reg,), (), qk, ql, qv, "member")
    return wpos > 0


def _launch(pos, neg, qk, ql, qv, name):
    regions = pos + neg
    if len(regions) > MAX_REGIONS:
        raise ValueError(f"at most {MAX_REGIONS} regions per launch")
    qk, qv = qk.contiguous(), qv.contiguous()
    _build.require_cuda(qk, qv)
    if ql is not None:
        ql = ql.contiguous()
        _build.require_cuda(ql)
    desc = _build.region_desc(regions)
    B = qk.shape[0]
    wpos = torch.empty(B, dtype=torch.int32, device=qk.device)
    wneg = torch.empty(B, dtype=torch.int32, device=qk.device)
    lib = _build.lib("intersect")
    rc = lib.repro_signed_member(
        desc, len(pos), len(regions), _build.ptr(qk),
        int(qk.dtype == torch.int64), _build.ptr(ql), _build.ptr(qv), B,
        _build.ptr(wpos), _build.ptr(wneg), _build.stream_of(qk))
    _build.check("intersect", rc)
    count_launch(name if ql is None else f"{name}_lex")
    return wpos, wneg
