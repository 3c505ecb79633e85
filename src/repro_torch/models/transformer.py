"""Decoder-only transformer family: the dense LM archs' forward and
serving path (prefill and KV-cache decode).

One definition, config-selected features: GQA with a separate head_dim
(gemma), RoPE, RMSNorm (optionally gemma's ``1 + w``), SwiGLU / GeGLU,
full, sliding-window and local/global attention (gemma2), and logit
softcaps (gemma2).  Every attention goes through
:func:`repro_torch.kernels.flash_attention.mha`: on the card the
hand-written flash-attention kernel, on the host its plain version.

Parameters keep the JAX package's names and its stacked ``[L, ...]``
layer layout (``embed``, ``final_norm``, ``layers.{ln1, ln2, wq, wk, wv,
wo, w_in, w_out}``); the layer stack is a Python loop with each layer's
window from ``cfg.layer_windows()``.  MoE (``_moe_mlp``) and training
(``make_train_step``, an attention backward) are later slices of the port:
an MoE config raises ``NotImplementedError``, and the kernel refuses
inputs that require grad, so the card runs this module under
``torch.no_grad()`` (``prefill`` and ``decode_step`` do so themselves).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.csr import resolve_device
from repro_torch.kernels.flash_attention import mha
from repro_torch.models import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"  # "silu" (SwiGLU) | "gelu" (GeGLU)
    # MoE (n_experts == 0 -> dense MLP)
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    # attention pattern
    window: int = 0  # sliding window width (0 = full)
    local_global_period: int = 0  # every p-th layer global, rest local
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10000.0
    norm_plus_one: bool = False
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d)
    param_dtype: Any = torch.bfloat16
    act_dtype: Any = torch.bfloat16

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_windows(self) -> np.ndarray:
        """Per-layer attention window (0 = full attention)."""
        if self.local_global_period > 0:
            return np.array(
                [0 if (l + 1) % self.local_global_period == 0
                 else self.window for l in range(self.num_layers)],
                np.int32)
        return np.full(self.num_layers, self.window, np.int32)

    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd \
            + self.n_heads * hd * d
        if self.is_moe:
            mlp = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            mlp = 3 * d * self.d_ff
        per_layer = attn + mlp + 2 * d
        return self.num_layers * per_layer + self.vocab * d + d

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        inactive = (self.n_experts - self.top_k) * 3 * d * self.d_ff
        return self.param_count() - self.num_layers * inactive


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers (_moe_mlp) are a later slice of the "
            f"port (ROADMAP.md); the port runs the dense archs")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: TransformerConfig) -> Params:
    """The parameter tree, drawn from ``gen`` on its device."""
    _dense_only(cfg)
    Lr, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim
    H, K, ff, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab
    pd = cfg.param_dtype
    dev = gen.device

    def li(shape, fan_in):
        return L.he_init(gen, (Lr,) + shape, pd, fan_in)

    def norm(*shape):
        fill = torch.zeros if cfg.norm_plus_one else torch.ones
        return fill(shape, dtype=pd, device=dev)

    layer = {
        "ln1": norm(Lr, d), "ln2": norm(Lr, d),
        "wq": li((d, H * hd), d),
        "wk": li((d, K * hd), d),
        "wv": li((d, K * hd), d),
        "wo": li((H * hd, d), H * hd),
        "w_in": li((d, 2 * ff), d),
        "w_out": li((ff, d), ff),
    }
    return {"embed": L.embed_init(gen, (V, d), pd),
            "final_norm": norm(d), "layers": layer}


class Transformer(nn.Module):
    """One dense transformer of :class:`TransformerConfig` on ``device``
    (``None``: the card; see ``csr.resolve_device``), parameters drawn on
    that device from ``seed``.  The passes below read the model's own
    ``cfg``."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        tree = init(gen, cfg)
        self.register_parameter("embed", nn.Parameter(tree["embed"]))
        self.register_parameter("final_norm",
                                nn.Parameter(tree["final_norm"]))
        self.add_module("layers", L.ParamTree(tree["layers"]))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attention(x, lp, cfg: TransformerConfig, pos0: int, window: int,
               kv_cache=None):
    """x [B, S, d] at positions pos0 .. pos0 + S - 1 (equal for every
    row).  With ``kv_cache`` ((k, v) [B, Smax, K, hd]) the new k/v are
    written into it in place and the queries attend over the whole cache
    (decode path).  Returns (out [B, S, d], (k, v) of these positions)."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ lp["wq"]).reshape(B, S, H, hd)
    k = (x @ lp["wk"]).reshape(B, S, K, hd)
    v = (x @ lp["wv"]).reshape(B, S, K, hd)
    positions = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        ck, cv = kv_cache
        # dynamic_update_slice's clamp: a start past Smax - S writes the
        # last S slots
        c = min(max(pos0, 0), ck.shape[1] - S)
        ck[:, c:c + S] = k.to(ck.dtype)
        cv[:, c:c + S] = v.to(cv.dtype)
        k_all, v_all = ck, cv
    else:
        k_all, v_all = k, v
    out = mha(q, k_all, v_all, causal=True, window=window,
              softcap=cfg.attn_softcap, q_offset=pos0)
    return out.reshape(B, S, H * hd) @ lp["wo"], (k, v)


def _block(x, lp, cfg: TransformerConfig, pos0: int, window: int,
           kv_cache=None):
    h, kv = _attention(
        L.rms_norm(x, lp["ln1"], plus_one=cfg.norm_plus_one), lp, cfg,
        pos0, window, kv_cache)
    x = x + h
    y = L.rms_norm(x, lp["ln2"], plus_one=cfg.norm_plus_one)
    return x + L.gated_mlp(y, lp["w_in"], lp["w_out"], cfg.act), kv


def _embed(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = model.embed[tokens.long()].to(cfg.act_dtype)
    if cfg.embed_scale:  # in the activation dtype, as the JAX package does
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _windows(cfg: TransformerConfig):
    return [int(w) for w in cfg.layer_windows()]


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def forward(model: Transformer, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final hidden states [B, S, d], aux loss: 0 for
    the dense archs)."""
    cfg = model.cfg
    x = _embed(model, tokens)
    for i, win in enumerate(_windows(cfg)):
        x, _ = _block(x, L.layer_slice(model.layers, i), cfg, 0, win)
    x = L.rms_norm(x, model.final_norm, plus_one=cfg.norm_plus_one)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(model: Transformer, hidden: torch.Tensor) -> torch.Tensor:
    """Tied unembedding.  hidden [..., d] -> logits [..., V]."""
    cfg = model.cfg
    lg = hidden @ model.embed.T
    if cfg.final_softcap > 0:
        lg = (torch.tanh(lg.to(torch.float32) / cfg.final_softcap)
              * cfg.final_softcap).to(lg.dtype)
    return lg


def _chunked_ce(model: Transformer, hidden: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy with the unembedding applied 512 positions at a
    time (when S divides), so the [B, S, V] logits are never whole."""
    cfg = model.cfg
    B, S, _ = hidden.shape
    CS = 512 if S % 512 == 0 else S
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, S, CS):
        lg = (hidden[:, c:c + CS] @ model.embed.T).to(torch.float32)
        if cfg.final_softcap > 0:
            lg = torch.tanh(lg / cfg.final_softcap) * cfg.final_softcap
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[:, c:c + CS, None].long())[..., 0]
        total = total + (lse - gold).sum()
    return total / (B * S)


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss's value: cross entropy + 0.01 aux."""
    hidden, aux = forward(model, batch["tokens"])
    ce = _chunked_ce(model, hidden, batch["labels"])
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---- serving ---------------------------------------------------------------

def make_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype=None, device=None) -> Dict[str, torch.Tensor]:
    """Zero k/v caches [L, batch, max_seq, K, hd] on ``device`` (``None``:
    the card)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.act_dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def decode_step(model: Transformer, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos):
    """One decode step.  tokens [B, 1]; ``pos`` the current length (an int
    or a 0-d tensor; the new token's position).

    Returns (logits [B, V], cache).  Unlike the JAX package, which returns
    a new cache, this writes the token's k/v into ``cache`` in place (at
    slot ``min(pos, Smax - 1)``, ``dynamic_update_slice``'s clamp) and
    returns the same dict."""
    cfg = model.cfg
    pos = int(pos)
    x = _embed(model, tokens)
    for i, win in enumerate(_windows(cfg)):
        x, _ = _block(x, L.layer_slice(model.layers, i), cfg, pos, win,
                      kv_cache=(cache["k"][i], cache["v"][i]))
    x = L.rms_norm(x, model.final_norm, plus_one=cfg.norm_plus_one)
    return logits_fn(model, x[:, 0]), cache


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor):
    """Prefill: the full forward, returning last-position logits and the
    cache.  tokens [B, S] -> (logits [B, V], cache with k/v [L, B, S, K,
    hd] in the activation dtype)."""
    cfg = model.cfg
    B, S = tokens.shape
    x = _embed(model, tokens)
    shape = (cfg.num_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    ks = torch.empty(shape, dtype=cfg.act_dtype, device=x.device)
    vs = torch.empty_like(ks)
    for i, win in enumerate(_windows(cfg)):
        x, (k, v) = _block(x, L.layer_slice(model.layers, i), cfg, 0, win)
        ks[i] = k
        vs[i] = v
    x = L.rms_norm(x, model.final_norm, plus_one=cfg.norm_plus_one)
    return logits_fn(model, x[:, -1]), {"k": ks, "v": vs}
