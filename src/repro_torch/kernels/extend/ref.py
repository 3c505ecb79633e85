"""Plain PyTorch version of the fused extension step: the stage sequence of
the reference BiGJoin level (``middle_jnp`` in the JAX package's
``core/bigjoin.py``) on plain searches only, so it runs on any device
without reaching a kernel."""
from __future__ import annotations

import torch

from repro_torch.core.csr import index_member, index_range


def fused_extend_ref(pos, neg, qks, wk, valid, batch: int):
    """See :func:`repro_torch.kernels.extend.ops.fused_extend`."""
    B = int(batch)
    dev = wk.device
    W = wk.shape[0]
    valid = valid.to(torch.bool)
    wk = wk.to(torch.int32)
    # ---- count minimization (one pass per binding) ------------------------
    starts_b, counts_b, totals = [], [], []
    for regions, qk in zip(pos, qks):
        ss, cs = [], []
        for reg in regions:
            s, c = index_range(reg, qk)
            ss.append(s)
            cs.append(c)
        s, c = torch.stack(ss, -1), torch.stack(cs, -1)
        starts_b.append(s)
        counts_b.append(c)
        totals.append(c.sum(-1, dtype=torch.int32))
    tot = torch.stack(totals, -1)  # [W, NB]
    min_i = torch.argmin(tot, -1)  # the first index among ties
    min_c = tot.gather(-1, min_i[:, None])[:, 0]
    min_i = min_i.to(torch.int32)
    # ---- proposal budget allocation (rem-ext resumption) ------------------
    remaining = torch.where(valid, torch.clamp(min_c - wk, min=0), 0
                            ).to(torch.int32)
    acum = torch.cumsum(remaining, 0, dtype=torch.int32)
    allowed = torch.minimum(torch.clamp(B - (acum - remaining), min=0),
                            remaining).to(torch.int32)
    consumed = valid & (allowed == remaining)
    aacum = torch.cumsum(allowed, 0, dtype=torch.int32)
    t = torch.arange(B, dtype=torch.int32, device=dev)
    pvalid = t < aacum[-1]
    r = torch.searchsorted(aacum, t, side="right").clamp(0, W - 1)
    rl = r.long()
    r = r.to(torch.int32)
    k_off = t - (aacum[rl] - allowed[rl]) + wk[rl]
    # ---- candidate proposal -----------------------------------------------
    cand = torch.zeros(B, dtype=torch.int32, device=dev)
    for bi, regions in enumerate(pos):
        val = torch.zeros(B, dtype=torch.int32, device=dev)
        off = k_off
        starts, counts = starts_b[bi][rl], counts_b[bi][rl]
        for ri, reg in enumerate(regions):
            in_r = (off >= 0) & (off < counts[:, ri])
            p = (starts[:, ri] + off).clamp(0, reg.capacity - 1).long()
            val = torch.where(in_r, reg.val[p], val)
            off = off - counts[:, ri]
        cand = torch.where(min_i[rl] == bi, val, cand)
    # ---- intersection: signed membership ----------------------------------
    alive = pvalid
    n_isect = torch.zeros((), dtype=torch.int32, device=dev)
    for bi, (p_regions, n_regions, qk) in enumerate(zip(pos, neg, qks)):
        q = (qk[0][rl], qk[1][rl]) if isinstance(qk, tuple) else qk[rl]
        wpos = torch.zeros(B, dtype=torch.int32, device=dev)
        wneg = torch.zeros(B, dtype=torch.int32, device=dev)
        for reg in p_regions:
            wpos = wpos + index_member(reg, q, cand).to(torch.int32)
        for reg in n_regions:
            wneg = wneg + index_member(reg, q, cand).to(torch.int32)
        is_min = min_i[rl] == bi
        ok = torch.where(is_min, ~(wneg > 0), (wpos - wneg) > 0)
        n_isect = n_isect + (alive & ~is_min).sum(dtype=torch.int32)
        alive = alive & ok
    counters = torch.stack([pvalid.sum(dtype=torch.int32), n_isect])
    return cand, r, alive, allowed, consumed, counters
