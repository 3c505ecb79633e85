"""Merge ranks: (lt, le) of each query in a sorted region.

Replaces the TPU kernel ``src/repro/kernels/merge/merge.py``
(``rank_kernel`` / ``_rank_call`` / ``rank_counts``, reached through
``ops.rank_lt_le``), 1-word keys.  The CUDA kernel is
``csrc/merge_rank.cu``: one thread per query, two bisections over the live
entries; it is bound by the scattered reads of the searches (see the source
note there).  ``ref.rank_ref`` is its plain version.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.merge.ref import rank_ref


def rank_lt_le(keys, vals, n, qk, qv):
    """(lt, le) int32 [B] merge ranks of each (qk, qv) in the sorted
    (keys, vals) region with ``n`` live entries."""
    qv = qv.to(torch.int32)
    if not keys.is_cuda:
        return rank_ref(keys, vals, n, qk, qv)
    return _launch(keys, vals, n, qk, qv)


def _launch(keys, vals, n, qk, qv):
    region = SimpleNamespace(key=keys.contiguous(), val=vals.contiguous(),
                             n=n.to(torch.int32))
    qk, qv = qk.contiguous(), qv.contiguous()
    _build.require_cuda(qk, qv)
    desc = _build.region_desc((region,))
    B = qk.shape[0]
    lt = torch.empty(B, dtype=torch.int32, device=keys.device)
    le = torch.empty(B, dtype=torch.int32, device=keys.device)
    lib = _build.lib("merge_rank")
    rc = lib.repro_rank(desc, _build.ptr(qk), int(qk.dtype == torch.int64),
                        _build.ptr(qv), B, _build.ptr(lt), _build.ptr(le),
                        _build.stream_of(keys))
    _build.check("merge_rank", rc)
    count_launch("rank_lt_le")
    return lt, le
