"""Multi-region signed membership: every region of a versioned index in one
launch.

Replaces the TPU kernel ``src/repro/kernels/intersect/intersect.py``
(``_make_multi_member_kernel`` / ``_multi_member_call``, reached through
``ops.signed_member``), 1-word and composite (hi, lo) keys.  The CUDA
kernel is ``csrc/intersect.cu``: one thread per query looping over the
region descriptors; it is bound by the scattered reads of its binary
searches (see the source note there).  ``ref.signed_member_ref`` is its
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.intersect.ref import signed_member_ref

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
    return _launch(tuple(pos), tuple(neg), qk, ql, qv)


def _launch(pos, neg, qk, ql, qv):
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
    count_launch("signed_member" if ql is None else "signed_member_lex")
    return wpos, wneg
