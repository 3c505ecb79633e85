"""Blocked online-softmax attention: the attention of the LM transformer.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/
flash_attention.py`` (``flash_kernel`` / ``_flash_call``, reached through
``ops.mha``).  The CUDA source is ``csrc/flash_attention.cu``, three
routes by :func:`route` (see the source note there): bf16 prefill on the
tensor cores (wgmma fed by TMA, P split into two bf16 halves), f32 prefill
on the CUDA cores, and decode (G * Sq <= 8 rows a KV group, either type)
split over the cache, then combined.  Causal masking, a sliding window, a
tanh softcap and a query offset; GQA reads each query head's KV head by
index.  ``ref.attention_ref`` is the plain version, and
``ref.attention_split_ref`` the decode route's split and combine.

Neither kernel has a backward, as the TPU kernel has none: a CUDA call
whose inputs require grad raises.  Training attends as the JAX package's
does, through ``models.transformer._attend``, which autograd
differentiates; only prefill and decode run this kernel.

On ``meta`` tensors (the dry run) a call takes the kernel's path up to
the launch: its checks and route, its output and the decode split's
partials, empty; then it adds :func:`kernel_ops` to
``kernels.META_OPS``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, count_launch, count_meta_ops
from repro_torch.kernels.flash_attention.ref import (DECODE_ROWS,
                                                     attention_ref, mha_ref,
                                                     split_plan)

# head dims of the bf16 prefill kernel (one template instance each)
PREFILL_DIMS = (32, 64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float = 1.0,
                    q_offset: int = 0) -> torch.Tensor:
    """q [H, Sq, Dh]; k, v [H, Sk, Dh] -> [H, Sq, Dh] in q's dtype, each
    head on its own (``_flash_call``).  ``q_offset`` is the position of
    query row 0 (decode: the cache length).  A CPU tensor takes the plain
    version, a CUDA tensor the kernel."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention takes q [H, Sq, Dh] and k, v "
                         f"[H, Sk, Dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.is_cuda or q.is_meta):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale,
                             q_offset=q_offset)
    # each head is a batch of one head: [H, S, 1, Dh]
    return _launch(q[:, :, None], k[:, :, None], v[:, :, None], causal,
                   window, softcap, scale, q_offset)[:, :, 0]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = True, window: int = 0, softcap: float = 0.0,
        q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, Hq, Dh]; k, v [B, Sk, Hkv, Dh] -> [B, Sq, Hq, Dh], scale
    1 / sqrt(Dh).  GQA: Hq is a multiple of Hkv and query head h reads KV
    head h // (Hq // Hkv).  A CPU tensor takes the plain version
    (``ref.mha_ref``: the JAX wrapper's head repeat and batch fold), a
    CUDA tensor the kernel, which reads the KV heads by index."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"mha takes q [B, Sq, Hq, Dh] and k, v "
                         f"[B, Sk, Hkv, Dh] with Hkv dividing Hq, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.is_cuda or q.is_meta):
        return mha_ref(q, k, v, causal=causal, window=window,
                       softcap=softcap, q_offset=q_offset)
    return _launch(q, k, v, causal, window, softcap,
                   1.0 / (q.shape[3] ** 0.5), q_offset)


def live_pairs(sq: int, sk: int, causal: bool, window: int,
               q_offset: int) -> int:
    """Live (query, key) pairs of one head: ``sq`` query rows at
    positions q_offset.. over ``sk`` keys, causal or not, with a window
    (0: none) that keeps keys after position - window."""
    p = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(p, sk - 1) if causal else np.full_like(p, sk - 1)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros_like(p)
    return int(np.maximum(hi - lo + 1, 0).sum())


def kernel_ops(q_shape, sk: int, causal: bool = True, window: int = 0,
               q_offset: int = 0) -> int:
    """Operations of one call on q [B, Sq, Hq, Dh] over ``sk`` keys: two
    (multiply, add) pairs a live pair and head dimension, for q·k and
    p·v."""
    B, Sq, Hq, Dh = q_shape
    return 4 * Dh * B * Hq * live_pairs(Sq, sk, causal, window, q_offset)


def route(dtype: torch.dtype, rows: int, head_dim: int) -> str:
    """The kernel a call takes: "decode" for ``rows`` = G * Sq <=
    DECODE_ROWS (either type; Dh a multiple of the 16-byte vector),
    "prefill" for bf16 (Dh in PREFILL_DIMS), "prefill_f32" for f32 (Dh a
    multiple of 4 up to 256).  Raises ValueError on anything else."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the flash-attention kernels take f32 or bf16, "
                         f"got {dtype}")
    bf16 = dtype == torch.bfloat16
    if rows <= DECODE_ROWS:
        vec = 8 if bf16 else 4
        if head_dim % vec or not 0 < head_dim <= 256:
            raise ValueError(f"head_dim {head_dim}: the decode kernel takes "
                             f"a multiple of {vec} up to 256 in {dtype}")
        return "decode"
    if bf16:
        if head_dim not in PREFILL_DIMS:
            raise ValueError(f"head_dim {head_dim}: the bf16 prefill kernel "
                             f"takes {PREFILL_DIMS}")
        return "prefill"
    if head_dim % 4 or not 4 <= head_dim <= 256:
        raise ValueError(f"head_dim {head_dim}: the f32 prefill kernel "
                         f"takes a multiple of 4 up to 256")
    return "prefill_f32"


def _launch(q, k, v, causal, window, softcap, scale, q_offset, plan=None):
    """The kernel on q [B, Sq, Hq, Dh], k, v [B, Sk, Hkv, Dh].  ``plan``
    overrides the decode route's (kb, ke, chunk, splits)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash-attention kernel has no backward (nor has the TPU "
            "kernel); training attends through models.transformer._attend")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the flash-attention kernel takes q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    meta = q.is_meta
    if meta:
        if not (k.is_meta and v.is_meta):
            raise ValueError("mixed meta and other operands to the "
                             "flash-attention kernel")
    else:
        _build.require_cuda(q, k, v)
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Sk < 1 or q_offset < 0 or window < 0 or softcap < 0:
        raise ValueError(f"Sk {Sk}, q_offset {q_offset}, window {window}, "
                         f"softcap {softcap}: the kernel takes Sk >= 1 and "
                         f"no negative offset, window or softcap")
    for t in () if meta else (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("the kernel takes 16-byte aligned tensors")
    way = route(q.dtype, Hq // Hkv * Sq, Dh)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if way == "decode":
        kb, ke, chunk, splits = plan or split_plan(
            Sq, Sk, causal, window, q_offset, B * Hkv)
        rows = B * Hkv * splits * (Hq // Hkv) * Sq
        ws = torch.empty(rows * (Dh + 2), dtype=torch.float32,
                         device=q.device)
    if meta:
        count_meta_ops("flash_attention", kernel_ops(
            tuple(q.shape), Sk, causal, window, q_offset))
        return out
    lib = _build.lib("flash_attention")
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), B, Sq, Sk, Hq, Hkv, Dh,
            int(bool(causal)), int(window), ctypes.c_float(softcap),
            ctypes.c_float(scale), int(q_offset))
    if way == "decode":
        rc = lib.repro_flash_decode(
            *head, kb, ke, chunk, splits, ws.data_ptr(),
            ws.data_ptr() + 4 * rows, ws.data_ptr() + 8 * rows,
            _build.stream_of(q))
    else:
        rc = lib.repro_flash_prefill(*head, _build.stream_of(q))
    _build.check("flash_attention", rc)
    count_launch("flash_attention")
    return out
