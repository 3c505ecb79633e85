"""Plain PyTorch version of the merge-rank kernel: two fixed-depth
lexicographic searches (``csr.lex_searchsorted_cols`` with both sides)."""
from __future__ import annotations

import torch

from repro_torch.core.csr import lex_searchsorted, lex_searchsorted_cols


def rank_ref(keys, vals, n, qk, qv, lo=None, qlo=None):
    """(lt, le) int32 [B]: live entries lexicographically < / <= each
    (qk[, qlo], qv) query; mixed hi-word widths promote."""
    qv = qv.to(torch.int32)
    if lo is not None:
        cols = (keys, lo, vals)
        qcols = (qk, qlo.to(torch.int64), qv)
        return (lex_searchsorted_cols(cols, n, qcols, side="left"),
                lex_searchsorted_cols(cols, n, qcols, side="right"))
    lt = lex_searchsorted(keys, vals, n, qk, qv, side="left")
    le = lex_searchsorted(keys, vals, n, qk, qv, side="right")
    return lt, le
