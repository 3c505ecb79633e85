"""Plain PyTorch versions of the membership kernels: one fixed-depth
lexicographic search per region (``csr.index_member``)."""
from __future__ import annotations

import torch

from repro_torch.core.csr import IndexData, index_member


def signed_member_ref(pos, neg, qk, qv: torch.Tensor):
    """(wpos, wneg) int32 [B]: hit counts of each (qk, qv) over the
    positive / negative regions (``qk`` a (hi, lo) pair for composite
    regions)."""
    wpos = torch.zeros(qv.shape, dtype=torch.int32, device=qv.device)
    wneg = torch.zeros_like(wpos)
    for reg in pos:
        wpos = wpos + index_member(reg, qk, qv).to(torch.int32)
    for reg in neg:
        wneg = wneg + index_member(reg, qk, qv).to(torch.int32)
    return wpos, wneg


def member_ref(keys, vals, n, qk, qv: torch.Tensor, los=None, ql=None
               ) -> torch.Tensor:
    """[B] bool: is (qk[, ql], qv) among the first ``n`` entries of the
    sorted region (keys[, los], vals)?"""
    reg = IndexData(keys, vals, torch.as_tensor(n, dtype=torch.int32,
                                                device=keys.device), los)
    return index_member(reg, qk if ql is None else (qk, ql), qv)
