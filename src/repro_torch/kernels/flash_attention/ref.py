"""Plain PyTorch versions of the flash-attention kernels: the whole score
matrix at once (``attention_ref``), and the decode route's split over the
cache with its combine (``attention_split_ref``); f32 math."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
# the kernel against its plain version at the serving shapes in bf16: both
# compute in f32 and differ there by about 1e-6 of the largest term, then
# round once to bf16, so they may differ by one bf16 step, at most 2^-7 =
# 0.0078 of |plain| (rtol), plus the f32 difference where the output is
# near 0 (atol).  Outputs there are small (a row over n live keys has |o|
# ~ sqrt(e / n), 0.02 at n = 8192), so the JAX package's 2e-2 would pass a
# dropped key tile
FLASH_SERVE_TOL = dict(rtol=8e-3, atol=1e-5)
# decode (G * Sq rows of a KV group at most this many) goes through the
# split kernel; the split aims at this many blocks (132 SMs about four
# times over), each chunk of at least SPLIT_MIN_KEYS keys
DECODE_ROWS = 8
SPLIT_BLOCKS = 512
SPLIT_MIN_KEYS = 64


def live_range(sq: int, sk: int, causal: bool, window: int,
               q_offset: int) -> tuple:
    """[kb, ke): the keys live for some of ``sq`` rows at positions
    q_offset.. (causal edge of the last row, window edge of the first);
    every key when a row has no live key at all."""
    p_lo, p_hi = q_offset, q_offset + sq - 1
    if window > 0 and p_hi - window + 1 > sk - 1:
        return 0, sk
    ke = min(p_hi + 1, sk) if causal else sk
    kb = max(p_lo - window + 1, 0) if window > 0 else 0
    return kb, ke


def split_plan(sq: int, sk: int, causal: bool, window: int, q_offset: int,
               groups: int) -> tuple:
    """(kb, ke, chunk, splits) of the decode kernel for ``groups`` = B *
    Hkv: the live range cut into ``splits`` chunks of ``chunk`` keys, so
    that groups * splits comes near SPLIT_BLOCKS, no chunk is shorter than
    SPLIT_MIN_KEYS (but one) and none is empty."""
    kb, ke = live_range(sq, sk, causal, window, q_offset)
    n = ke - kb
    splits = max(1, min(-(-SPLIT_BLOCKS // max(groups, 1)),
                        -(-n // SPLIT_MIN_KEYS)))
    chunk = -(-n // splits)
    return kb, ke, chunk, -(-n // chunk)


def _scores(q, k, causal, window, softcap, scale, q_offset):
    """f32 scores [H, Sq, Sk] with the cap, masked scores NEG_INF."""
    qf = q.to(torch.float32) * scale
    s = torch.einsum("hqd,hkd->hqk", qf, k.to(torch.float32))
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    Sq, Sk = q.shape[1], k.shape[1]
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    return torch.where(mask[None], s, NEG_INF)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: float = 1.0,
                  q_offset: int = 0) -> torch.Tensor:
    """q [H, Sq, Dh]; k, v [H, Sk, Dh] -> [H, Sq, Dh] in q's dtype.

    Masked scores are ``NEG_INF``, so a row without a live key averages v
    over every key."""
    s = _scores(q, k, causal, window, softcap, scale, q_offset)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.to(torch.float32)).to(q.dtype)


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        splits: int, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float = 1.0,
                        q_offset: int = 0, bounds=None,
                        drop=None) -> torch.Tensor:
    """:func:`attention_ref` as the decode kernel computes it: the keys
    ``bounds`` = [kb, ke) (default: :func:`live_range`) cut into
    ``splits`` chunks of ceil((ke - kb) / splits); each chunk's (m, l,
    acc) over its keys below Sk (m = -inf, l = 0 for a chunk without
    keys); then o = sum w_s acc_s / sum w_s l_s with w_s = exp(m_s - max
    m), 0 for a chunk without keys.  ``drop`` (a chunk index) gives that
    chunk weight 0: a planted fault."""
    Sk = k.shape[1]
    kb, ke = bounds if bounds is not None else live_range(
        q.shape[1], Sk, causal, window, q_offset)
    chunk = max(1, math.ceil((ke - kb) / splits))
    s_all = _scores(q, k, causal, window, softcap, scale, q_offset)
    vf = v.to(torch.float32)
    H, Sq, D = q.shape
    ms, ls, accs = [], [], []
    for sp in range(splits):
        lo = min(kb + sp * chunk, Sk)
        hi = min(kb + (sp + 1) * chunk, ke, Sk)
        if hi <= lo:
            ms.append(torch.full((H, Sq), -math.inf, device=q.device))
            ls.append(torch.zeros((H, Sq), device=q.device))
            accs.append(torch.zeros((H, Sq, D), device=q.device))
            continue
        s = s_all[:, :, lo:hi]
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("hqk,hkd->hqd", p, vf[:, lo:hi]))
    m = torch.stack(ms)
    top = m.amax(0)
    w = torch.where(m == -math.inf, torch.zeros_like(m),
                    torch.exp(m - top))
    if drop is not None:
        w[drop] = 0.0
    den = (w * torch.stack(ls)).sum(0).clamp_min(1e-30)
    o = (w[..., None] * torch.stack(accs)).sum(0) / den[..., None]
    return o.to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window: int = 0, softcap: float = 0.0,
            q_offset: int = 0, splits=None, bounds=None,
            drop=None) -> torch.Tensor:
    """q [B, Sq, Hq, Dh]; k, v [B, Sk, Hkv, Dh] -> [B, Sq, Hq, Dh], scale
    1 / sqrt(Dh), as the JAX wrapper computes it: KV heads repeated per
    group, batch and heads folded, then :func:`attention_ref`, or
    :func:`attention_split_ref` when ``splits`` is given."""
    B, Sq, Hq, Dh = q.shape
    rep = Hq // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qh = q.permute(0, 2, 1, 3).reshape(B * Hq, Sq, Dh)
    kh = k.permute(0, 2, 1, 3).reshape(B * Hq, -1, Dh)
    vh = v.permute(0, 2, 1, 3).reshape(B * Hq, -1, Dh)
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale=1.0 / (Dh ** 0.5), q_offset=q_offset)
    if splits is None:
        o = attention_ref(qh, kh, vh, **kw)
    else:
        o = attention_split_ref(qh, kh, vh, splits, bounds=bounds,
                                drop=drop, **kw)
    return o.reshape(B, Hq, Sq, Dh).permute(0, 2, 1, 3)
