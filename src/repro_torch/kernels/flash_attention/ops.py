"""Blocked online-softmax attention: the attention of the LM transformer.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/
flash_attention.py`` (``flash_kernel`` / ``_flash_call``, reached through
``ops.mha``).  The CUDA kernel is ``csrc/flash_attention.cu``: f32 math
from f32 or bf16 inputs, key tiles of 32 with an online softmax, causal
masking, a sliding window, a tanh softcap and a query offset; GQA reads
each query head's KV head by index (see the source note there).
``ref.attention_ref`` is its plain version.

Neither kernel has a backward: a CUDA call whose inputs require grad
raises (LM training, with an attention backward, is a later slice of the
port, ``ROADMAP.md``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.flash_attention.ref import attention_ref, mha_ref


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
    if not q.is_cuda:
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
    if not q.is_cuda:
        return mha_ref(q, k, v, causal=causal, window=window,
                       softcap=softcap, q_offset=q_offset)
    return _launch(q, k, v, causal, window, softcap,
                   1.0 / (q.shape[3] ** 0.5), q_offset)


def _launch(q, k, v, causal, window, softcap, scale, q_offset):
    """The kernel on q [B, Sq, Hq, Dh], k, v [B, Sk, Hkv, Dh]."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash-attention kernel has no backward; LM training (an "
            "attention backward) is a later slice of the port (ROADMAP.md)")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the flash-attention kernel takes f32 or bf16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _build.require_cuda(q, k, v)
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Dh % 4 or not 4 <= Dh <= 256:
        raise ValueError(f"head_dim {Dh}: the kernel takes a multiple of 4 "
                         f"up to 256")
    if Sk < 1 or q_offset < 0 or window < 0 or softcap < 0:
        raise ValueError(f"Sk {Sk}, q_offset {q_offset}, window {window}, "
                         f"softcap {softcap}: the kernel takes Sk >= 1 and "
                         f"no negative offset, window or softcap")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("the kernel takes 16-byte aligned tensors")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.lib("flash_attention")
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, Sq, Sk, Hq, Hkv, Dh,
        int(bool(causal)), int(window), ctypes.c_float(softcap),
        ctypes.c_float(scale), int(q_offset), _build.stream_of(q))
    _build.check("flash_attention", rc)
    count_launch("flash_attention")
    return out
