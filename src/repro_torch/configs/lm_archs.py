"""The five assigned LM architectures — exact configs from the assignment.

[source; verified-tier] annotations are in the describe strings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.lm_family import lm_arch
from repro_torch.models.transformer import TransformerConfig


def _smoke(name, **kw):
    base = dict(num_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab=199,
                param_dtype=torch.float32, act_dtype=torch.float32)
    base.update(kw)
    return TransformerConfig(name + "-smoke", **base)


LLAMA4_SCOUT = lm_arch(
    "llama4-scout-17b-a16e",
    "48L d5120 40H(kv8) ff8192 v202048 MoE16 top-1; chunked-local + "
    "periodic-global attention (iRoPE) [hf:meta-llama/Llama-4-Scout-17B-16E;"
    " unverified]",
    TransformerConfig(
        "llama4-scout-17b-a16e", num_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048,
        n_experts=16, top_k=1, window=8192, local_global_period=4,
        rope_theta=500000.0),
    _smoke("llama4-scout", n_experts=4, top_k=1, window=8,
           local_global_period=4))

MIXTRAL_8X7B = lm_arch(
    "mixtral-8x7b",
    "32L d4096 32H(kv8) ff14336 v32000 MoE8 top-2, sliding-window attention"
    " [arXiv:2401.04088; hf]",
    TransformerConfig(
        "mixtral-8x7b", num_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32000,
        n_experts=8, top_k=2, window=4096, rope_theta=1e6),
    _smoke("mixtral", n_experts=4, top_k=2, window=8))

YI_34B = lm_arch(
    "yi-34b",
    "60L d7168 56H(kv8) ff20480 v64000 dense llama-arch GQA, full attention"
    " [arXiv:2403.04652; hf]",
    TransformerConfig(
        "yi-34b", num_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        head_dim=128, d_ff=20480, vocab=64000, rope_theta=5e6),
    _smoke("yi"))

GEMMA_7B = lm_arch(
    "gemma-7b",
    "28L d3072 16H(kv16) head_dim=256 ff24576 v256000 dense GeGLU, full "
    "attention [arXiv:2403.08295; hf]",
    TransformerConfig(
        "gemma-7b", num_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
        head_dim=256, d_ff=24576, vocab=256000, act="gelu",
        norm_plus_one=True, embed_scale=True),
    _smoke("gemma7b", act="gelu", norm_plus_one=True, embed_scale=True,
           n_kv_heads=4))

GEMMA2_2B = lm_arch(
    "gemma2-2b",
    "26L d2304 8H(kv4) head_dim=256 ff9216 v256000, local/global "
    "alternating, logit softcaps [arXiv:2408.00118; hf]",
    TransformerConfig(
        "gemma2-2b", num_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        head_dim=256, d_ff=9216, vocab=256000, act="gelu",
        window=4096, local_global_period=2, attn_softcap=50.0,
        final_softcap=30.0, norm_plus_one=True, embed_scale=True),
    _smoke("gemma2", act="gelu", window=8, local_global_period=2,
           attn_softcap=50.0, final_softcap=30.0, norm_plus_one=True,
           embed_scale=True))

LM_ARCHS = (LLAMA4_SCOUT, MIXTRAL_8X7B, YI_34B, GEMMA_7B, GEMMA2_2B)
