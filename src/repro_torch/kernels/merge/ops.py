"""Merge ranks: (lt, le) of each query in a sorted region.

Replaces the TPU kernel ``src/repro/kernels/merge/merge.py``
(``rank_kernel`` / ``_rank_call`` / ``rank_counts``, reached through
``ops.rank_lt_le``), 1-word and composite (hi, lo) keys.  The CUDA
kernel is ``csrc/merge_rank.cu``: a block ranks a chunk of consecutive
queries; sorted ones (every caller passes a sorted region) through the
region's slice between the chunk's first and last ranks, staged in shared
memory; any others by lane-group searches; ``le`` from ``lt`` by one
compare.  It is bound by the bytes of the queries and ranks (see the
source note there).  ``ref.rank_ref`` is its plain version.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.merge.ref import rank_ref


def rank_lt_le(keys, vals, n, qk, qv, lo=None, qlo=None):
    """(lt, le) int32 [B] merge ranks of each (qk[, qlo], qv) in the sorted
    (keys[, lo], vals) region with ``n`` live entries; ``lo``/``qlo`` are
    the int64 lo words of a composite key (a narrow hi word promotes)."""
    qv = qv.to(torch.int32)
    if (lo is None) != (qlo is None):
        raise ValueError("a composite region takes (hi, lo) queries")
    if lo is not None:
        qk, qlo = qk.to(torch.int64), qlo.to(torch.int64)
    if not keys.is_cuda:
        return rank_ref(keys, vals, n, qk, qv, lo=lo, qlo=qlo)
    return _launch(keys, vals, n, qk, qv, lo, qlo)


def _launch(keys, vals, n, qk, qv, lo, qlo):
    region = SimpleNamespace(key=keys.contiguous(), val=vals.contiguous(),
                             n=n.to(torch.int32),
                             lo=None if lo is None else lo.contiguous())
    qk, qv = qk.contiguous(), qv.contiguous()
    _build.require_cuda(qk, qv)
    if qlo is not None:
        qlo = qlo.contiguous()
        _build.require_cuda(qlo)
    desc = _build.region_desc((region,))
    B = qk.shape[0]
    lt = torch.empty(B, dtype=torch.int32, device=keys.device)
    le = torch.empty(B, dtype=torch.int32, device=keys.device)
    lib = _build.lib("merge_rank")
    rc = lib.repro_rank(desc, _build.ptr(qk), int(qk.dtype == torch.int64),
                        _build.ptr(qlo), _build.ptr(qv), B, _build.ptr(lt),
                        _build.ptr(le), _build.stream_of(keys))
    _build.check("merge_rank", rc)
    count_launch("rank_lt_le" if lo is None else "rank_lt_le_lex")
    return lt, le
