"""Plain PyTorch version of the multi-region signed-membership kernel:
one fixed-depth lexicographic search per region (``csr.index_member``)."""
from __future__ import annotations

import torch

from repro_torch.core.csr import index_member


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
