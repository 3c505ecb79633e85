"""Plain PyTorch version of the merge-rank kernel: two fixed-depth
lexicographic searches (``csr.lex_searchsorted_cols`` with both sides)."""
from __future__ import annotations

import torch

from repro_torch.core.csr import lex_searchsorted


def rank_ref(keys, vals, n, qk, qv):
    """(lt, le) int32 [B]: live entries lexicographically < / <= each
    (qk, qv) query."""
    qv = qv.to(torch.int32)
    lt = lex_searchsorted(keys, vals, n, qk, qv, side="left")
    le = lex_searchsorted(keys, vals, n, qk, qv, side="right")
    return lt, le
