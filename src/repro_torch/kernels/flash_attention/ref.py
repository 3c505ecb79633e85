"""Plain PyTorch version of the flash-attention kernel: the whole score
matrix at once, f32 math."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale: float = 1.0,
                  q_offset: int = 0) -> torch.Tensor:
    """q [H, Sq, Dh]; k, v [H, Sk, Dh] -> [H, Sq, Dh] in q's dtype.

    Masked scores are ``NEG_INF``, so a row without a live key averages v
    over every key."""
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
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.to(torch.float32)).to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window: int = 0, softcap: float = 0.0,
            q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, Hq, Dh]; k, v [B, Sk, Hkv, Dh] -> [B, Sq, Hq, Dh], scale
    1 / sqrt(Dh), as the JAX wrapper computes it: KV heads repeated per
    group, batch and heads folded, then :func:`attention_ref`."""
    B, Sq, Hq, Dh = q.shape
    rep = Hq // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qh = q.permute(0, 2, 1, 3).reshape(B * Hq, Sq, Dh)
    kh = k.permute(0, 2, 1, 3).reshape(B * Hq, -1, Dh)
    vh = v.permute(0, 2, 1, 3).reshape(B * Hq, -1, Dh)
    o = attention_ref(qh, kh, vh, causal=causal, window=window,
                      softcap=softcap, scale=1.0 / (Dh ** 0.5),
                      q_offset=q_offset)
    return o.reshape(B, Hq, Sq, Dh).permute(0, 2, 1, 3)
