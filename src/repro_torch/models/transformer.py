"""Decoder-only transformer family covering the five assigned LM archs:
the training forward and loss, and the serving path (prefill and
KV-cache decode).

One definition, config-selected features: GQA with a separate head_dim
(gemma), RoPE, RMSNorm (optionally gemma's ``1 + w``), SwiGLU / GeGLU,
MoE (mixtral 8x top-2, llama4-scout 16x top-1) with the JAX package's
sort-based capacity-bounded dispatch (:func:`_moe_mlp`), full,
sliding-window and local/global attention (gemma2, llama4-scout), and
logit softcaps (gemma2).

The pass picks the attention.  ``forward`` and ``loss_fn``, what training
differentiates, attend through :func:`_attend`, the JAX package's own
training attention (its ``attend``: q-chunked scores in plain matmuls;
the JAX model never reaches its Pallas kernel, which has no backward),
with each layer and each cross-entropy chunk recomputed in backward
(``torch.utils.checkpoint``, the JAX package's default ``remat``).
``prefill`` and ``decode_step`` attend through
:func:`repro_torch.kernels.flash_attention.mha`: on the card the
hand-written flash-attention kernel, on the host its plain version.

Parameters keep the JAX package's names and its stacked ``[L, ...]``
layer layout (``embed``, ``final_norm``, ``layers.{ln1, ln2, wq, wk, wv,
wo, w_in, w_out}`` and, for MoE, ``router`` with experts' ``w_in``
``[L, E, d, 2ff]`` and ``w_out`` ``[L, E, ff, d]``); the layer stack is a
Python loop with each layer's window from ``cfg.layer_windows()``.
``logical_axes`` and ``cache_logical_axes`` are the JAX package's
sharding metadata as plain data (``distributed.sharding`` maps them);
``abstract_params`` and ``abstract_cache`` are the model and cache on
``meta`` that the dry run's cells take.  The JAX package's
``gather_fsdp`` is not ported: it only places ``with_sharding_constraint``
hints for XLA, and eager PyTorch in one process has nothing to hint.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer attends over unbounded context with full
        attention alone (a window, or local layers between global ones):
        the long_500k cell runs only for these."""
        return bool(self.window > 0 and self.local_global_period == 0) or \
            self.local_global_period > 0

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


# ---------------------------------------------------------------------------
# init + metadata
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: TransformerConfig) -> Params:
    """The parameter tree, drawn from ``gen`` on its device (a host
    generator's on the current default device, as ``layers.he_init``
    draws: under ``torch.device("meta")``, shapes only)."""
    Lr, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim
    H, K, ff, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab
    pd = cfg.param_dtype
    dev = gen.device if gen.device.type != "cpu" else None

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
    }
    if cfg.is_moe:
        E = cfg.n_experts
        layer.update({
            "router": li((d, E), d),
            "w_in": li((E, d, 2 * ff), d),
            "w_out": li((E, ff, d), ff),
        })
    else:
        layer.update({
            "w_in": li((d, 2 * ff), d),
            "w_out": li((ff, d), ff),
        })
    return {"embed": L.embed_init(gen, (V, d), pd),
            "final_norm": norm(d), "layers": layer}


def logical_axes(cfg: TransformerConfig) -> Params:
    """Each parameter's logical axis names (the JAX package's table:
    ``distributed.sharding.ShardingRules`` maps them to mesh axes)."""
    layer = {
        "ln1": (None, None), "ln2": (None, None),
        "wq": (None, "embed", "heads"),
        "wk": (None, "embed", "kv_heads"),
        "wv": (None, "embed", "kv_heads"),
        "wo": (None, "heads", "embed"),
    }
    if cfg.is_moe:
        layer.update({
            "router": (None, "embed", None),
            # expert -> model when E divides the axis (llama4: 16); else the
            # mlp dim takes it (mixtral: 8 experts fall back to ff sharding)
            "w_in": (None, "expert", "embed", "mlp"),
            "w_out": (None, "expert", "mlp", "embed"),
        })
    else:
        layer.update({
            "w_in": (None, "embed", "mlp"),
            "w_out": (None, "mlp", "embed"),
        })
    return {"embed": ("vocab", None),
            "final_norm": (None,), "layers": layer}


def cache_logical_axes(cfg: TransformerConfig, shard_seq: bool = True):
    """KV cache [L, B, S, K, hd]: batch over the data axes, sequence over
    the model axis (the shape-aware rules drop an axis that does not
    divide, e.g. batch 1)."""
    ax = (None, "batch", "seq_shard" if shard_seq else None, None, None)
    return {"k": ax, "v": ax}


def abstract_params(cfg: TransformerConfig) -> "Transformer":
    """The model of ``cfg`` on ``meta``: every parameter's shape and dtype,
    no memory (the JAX package's ``eval_shape`` of ``init``)."""
    return Transformer(cfg, device="meta")


class Transformer(nn.Module):
    """One transformer of :class:`TransformerConfig` on ``device``
    (``None``: the card; see ``csr.resolve_device``), parameters drawn on
    that device from ``seed`` (on ``meta``: shapes and dtypes, nothing
    drawn).  The passes below read the model's own ``cfg``."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        if device.type == "meta":
            with torch.device("meta"):
                tree = init(torch.Generator(), cfg)
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            tree = init(gen, cfg)
        self.register_parameter("embed", nn.Parameter(tree["embed"]))
        self.register_parameter("final_norm",
                                nn.Parameter(tree["final_norm"]))
        self.add_module("layers", L.ParamTree(tree["layers"]))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attend(q, k, v, window: int, softcap: float) -> torch.Tensor:
    """The training passes' causal attention (the JAX package's
    ``attend``).  q [B, S, H, hd]; k, v [B, S, K, hd] at positions 0 ..
    S - 1 -> [B, S, H, hd].  Queries go 512 at a time when S divides, else
    all at once; scores are computed in the activation dtype and scaled
    in f32 (the JAX package scales in f64 under its x64 mode: one f32
    rounding apart), softcapped, masked at -1e30, and the softmax's
    probabilities cast back to the activation dtype."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    q = q.reshape(B, S, K, H // K, hd)
    scale = 1.0 / np.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    CQ = 512 if S % 512 == 0 else S
    outs = []
    for c in range(0, S, CQ):
        s = torch.einsum("bqkgd,bskd->bkgqs", q[:, c:c + CQ], k)
        s = s.to(torch.float32) * scale
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        qp = pos[c:c + CQ, None]
        mask = pos[None, :] <= qp
        if window > 0:
            mask = mask & (pos[None, :] > qp - window)
        s = s.masked_fill(~mask, -1e30)
        probs = torch.softmax(s, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", probs, v))
    return torch.cat(outs, 1).reshape(B, S, H, hd)


def _flash(q, k, v, window: int, softcap: float, q_offset: int = 0):
    """The serving passes' attention: the flash kernel on the card."""
    return mha(q, k, v, causal=True, window=window, softcap=softcap,
               q_offset=q_offset)


def _attention(x, lp, cfg: TransformerConfig, pos0: int, window: int,
               attend, kv_cache=None):
    """x [B, S, d] at positions pos0 .. pos0 + S - 1 (equal for every
    row), attending through ``attend`` (:func:`_attend` or
    :func:`_flash`).  With ``kv_cache`` ((k, v) [B, Smax, K, hd]) the new
    k/v are written into it in place and the queries attend over the
    whole cache (decode path).  Returns (out [B, S, d], (k, v) of these
    positions)."""
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
        out = attend(q, ck, cv, window, cfg.attn_softcap, q_offset=pos0)
    else:
        out = attend(q, k, v, window, cfg.attn_softcap)
    return out.reshape(B, S, H * hd) @ lp["wo"], (k, v)


def _route(x2d: torch.Tensor, router: torch.Tensor,
           cfg: TransformerConfig) -> Dict[str, Any]:
    """The dispatch plan of tokens x2d [T, d]: each token's top-k experts
    (f32 router softmax, weights renormalised), token-major as ``ids`` and
    ``wts`` [T*k]; ``order``, the stable sort of the assignments by
    expert; and, in that order, each one's ``slot`` in the ``[E*C, d]``
    buffer and ``kept`` bit (its rank among its expert's assignments is
    below the capacity ``C``; a dropped one's slot is ``E*C``)."""
    T = x2d.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    C = int(np.ceil(cfg.capacity_factor * T * k / E / 8) * 8)
    probs = torch.softmax((x2d @ router).to(torch.float32), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)  # [T, k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    ids = topi.reshape(-1)
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    rank = torch.arange(T * k, device=x2d.device) \
        - torch.searchsorted(sid, sid)
    kept = rank < C
    return dict(probs=probs, ids=ids, wts=topv.reshape(-1), order=order,
                slot=torch.where(kept, sid * C + rank, E * C), kept=kept,
                capacity=C)


def _moe_mlp(x2d: torch.Tensor, lp, cfg: TransformerConfig):
    """Sort-based capacity-bounded MoE dispatch, step for step the JAX
    package's.  x2d [T, d] -> (out [T, d], Switch aux loss f32).

    Tokens are scattered to their slots (:func:`_route`; a dropped
    assignment's row ``E*C`` is cut off), the experts' gated MLPs are two
    batched matmuls over the ``[E, C, d]`` buffer, and each kept output
    goes back to its token, weighted, by a scatter-add."""
    T, d = x2d.shape
    E, k = cfg.n_experts, cfg.top_k
    r = _route(x2d, lp["router"], cfg)
    C, slot, kept, order = r["capacity"], r["slot"], r["kept"], r["order"]
    src = torch.div(order, k, rounding_mode="floor")  # each one's token

    buf = x2d.new_zeros((E * C + 1, d)).index_put((slot,), x2d[src])
    h = torch.bmm(buf[:E * C].view(E, C, d), lp["w_in"])
    gate, up = h.chunk(2, dim=-1)
    g = gate.to(torch.float32)
    g = F.silu(g) if cfg.act == "silu" else F.gelu(g, approximate="tanh")
    h = (g * up.to(torch.float32)).to(x2d.dtype)
    eout = torch.bmm(h, lp["w_out"]).reshape(E * C, d)

    contrib = eout[torch.clamp(slot, max=E * C - 1)]
    contrib = torch.where(kept[:, None], contrib, 0.0)
    out = x2d.new_zeros((T, d)).index_add(
        0, src, contrib * r["wts"][order][:, None].to(x2d.dtype))
    # load-balance aux loss (Switch-style); each expert's assignments
    # counted by a scatter-add (``bincount``'s, with a shape that does not
    # depend on the ids, so it runs on meta)
    ids = r["ids"]
    counts = ids.new_zeros(E).scatter_add_(0, ids, torch.ones_like(ids))
    frac = counts.to(torch.float32) / (T * k)
    aux = E * torch.sum(frac * r["probs"].mean(0))
    return out, aux


def _block(x, lp, cfg: TransformerConfig, pos0: int, window: int, attend,
           kv_cache=None):
    """One layer.  Returns (x, (k, v) of these positions, aux loss)."""
    h, kv = _attention(
        L.rms_norm(x, lp["ln1"], plus_one=cfg.norm_plus_one), lp, cfg,
        pos0, window, attend, kv_cache)
    x = x + h
    y = L.rms_norm(x, lp["ln2"], plus_one=cfg.norm_plus_one)
    if cfg.is_moe:
        B, S, d = y.shape
        out, aux = _moe_mlp(y.reshape(B * S, d), lp, cfg)
        y = out.reshape(B, S, d)
    else:
        y = L.gated_mlp(y, lp["w_in"], lp["w_out"], cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, kv, aux


def _remat(fn, *args):
    """``fn(*args)``, recomputed in backward when autograd records (the
    JAX package's ``remat``): values are unchanged."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


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

def _train_block(x, lp, cfg: TransformerConfig, window: int):
    x, _, aux = _block(x, lp, cfg, 0, window, _attend)
    return x, aux


def forward(model: Transformer, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final hidden states [B, S, d], the layers' summed
    aux loss, f32: 0 for the dense archs).  Attends through
    :func:`_attend`; each layer is recomputed in backward."""
    cfg = model.cfg
    x = _embed(model, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, win in enumerate(_windows(cfg)):
        x, a = _remat(_train_block, x, L.layer_slice(model.layers, i), cfg,
                      win)
        aux = aux + a
    x = L.rms_norm(x, model.final_norm, plus_one=cfg.norm_plus_one)
    return x, aux


def logits_fn(model: Transformer, hidden: torch.Tensor) -> torch.Tensor:
    """Tied unembedding.  hidden [..., d] -> logits [..., V]."""
    cfg = model.cfg
    lg = hidden @ model.embed.T
    if cfg.final_softcap > 0:
        lg = (torch.tanh(lg.to(torch.float32) / cfg.final_softcap)
              * cfg.final_softcap).to(lg.dtype)
    return lg


def _ce_chunk(embed, hidden, labels, softcap: float) -> torch.Tensor:
    """Summed cross entropy of one chunk: hidden [B, CS, d], labels
    [B, CS]."""
    lg = (hidden @ embed.T).to(torch.float32)
    if softcap > 0:
        lg = torch.tanh(lg / softcap) * softcap
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    return (lse - gold).sum()


def _chunked_ce(model: Transformer, hidden: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy with the unembedding applied 512 positions at a
    time (when S divides), so the [B, S, V] logits are never whole; each
    chunk is recomputed in backward."""
    cfg = model.cfg
    B, S, _ = hidden.shape
    CS = 512 if S % 512 == 0 else S
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, S, CS):
        total = total + _remat(_ce_chunk, model.embed, hidden[:, c:c + CS],
                               labels[:, c:c + CS], cfg.final_softcap)
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


def abstract_cache(cfg: TransformerConfig, batch: int, max_seq: int
                   ) -> Dict[str, torch.Tensor]:
    """:func:`make_cache`'s k/v on ``meta``: shapes and dtypes only."""
    return make_cache(cfg, batch, max_seq, device="meta")


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
        x, _, _ = _block(x, L.layer_slice(model.layers, i), cfg, pos, win,
                         _flash, kv_cache=(cache["k"][i], cache["v"][i]))
    x = L.rms_norm(x, model.final_norm, plus_one=cfg.norm_plus_one)
    return logits_fn(model, x[:, 0]), cache


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor):
    """Prefill: the full forward through the flash kernel, returning
    last-position logits and the cache.  tokens [B, S] -> (logits [B, V],
    cache with k/v [L, B, S, K, hd] in the activation dtype)."""
    cfg = model.cfg
    B, S = tokens.shape
    x = _embed(model, tokens)
    shape = (cfg.num_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    ks = torch.empty(shape, dtype=cfg.act_dtype, device=x.device)
    vs = torch.empty_like(ks)
    for i, win in enumerate(_windows(cfg)):
        x, (k, v), _ = _block(x, L.layer_slice(model.layers, i), cfg, 0,
                              win, _flash)
        ks[i] = k
        vs[i] = v
    x = L.rms_norm(x, model.final_norm, plus_one=cfg.norm_plus_one)
    return logits_fn(model, x[:, -1]), {"k": ks, "v": vs}
