"""GNN family: EGNN, GatedGCN, GAT, GraphCast-style encoder-processor-decoder.

Messages flow through ``segment_sum`` over an edge list: every
aggregation goes through :func:`repro_torch.kernels.segment_ops.segment_sum`,
so on the card it is the hand-written kernel (forward) and a gather
(backward), on the host its plain version.  GAT's ``segment_max`` is plain
PyTorch (``scatter_reduce``), as the JAX package computes it outside any
Pallas kernel.  All four archs share one graph-batch convention:

    batch = {
      "feats":  [N, F] f32,   "coords": [N, 3] (EGNN only),
      "edge_src": [E] i32, "edge_dst": [E] i32, "edge_mask": [E] bool,
      "labels": [N] i32 / [N, out] f32 / [G] f32, "label_mask": [N] bool,
      "graph_id": [N] i32 (molecule batches),
    }

Padded nodes/edges are masked, so one static shape serves sampled
minibatches (the union-graph flattening of sampler blocks), full batches,
and molecule batches.  Parameters keep the JAX package's names and its
stacked ``[L, ...]`` layer layout (``encode``, ``decode``, ``layers.*``,
``edge_encode``); the layer stack is a Python loop over the layer index.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.csr import resolve_device
from repro_torch.kernels.segment_ops import segment_sum
from repro_torch.models import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str  # "egnn" | "gatedgcn" | "gat" | "graphcast"
    n_layers: int
    d_hidden: int
    d_in: int
    d_out: int
    n_heads: int = 1
    aggregator: str = "sum"  # "sum" | "gated" | "attn"
    task: str = "node_class"  # "node_class" | "node_reg" | "graph_reg"
    param_dtype: Any = torch.float32
    act_dtype: Any = torch.float32

    def param_count(self) -> int:
        with torch.device("meta"):  # shapes only: nothing is drawn
            params = init(torch.Generator(), self)
        return sum(p.numel() for p in _leaves(params))


def _segsum(data, seg, num_segments):
    return segment_sum(data, seg, num_segments).to(data.dtype)


def _mlp2_shapes(din, dh, dout):
    return {"w1": (din, dh), "b1": (dh,), "w2": (dh, dout), "b2": (dout,)}


def _mlp2_init(gen, din, dh, dout, dtype):
    return {"w1": L.he_init(gen, (din, dh), dtype),
            "b1": torch.zeros(dh, dtype=dtype),
            "w2": L.he_init(gen, (dh, dout), dtype),
            "b2": torch.zeros(dout, dtype=dtype)}


def _mlp2(p, x):
    h = F.silu(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: GNNConfig) -> Params:
    """One layer's parameters (unstacked)."""
    d, pd = cfg.d_hidden, cfg.param_dtype
    if cfg.arch == "egnn":
        return {"phi_e": _mlp2_init(gen, 2 * d + 1, d, d, pd),
                "phi_x": _mlp2_init(gen, d, d, 1, pd),
                "phi_h": _mlp2_init(gen, 2 * d, d, d, pd)}
    if cfg.arch == "gatedgcn":
        out = {k: L.he_init(gen, (d, d), pd) for k in "ABCUV"}
        out.update(ln_h=torch.ones(d, dtype=pd),
                   ln_e=torch.ones(d, dtype=pd))
        return out
    if cfg.arch == "gat":
        H, dh = cfg.n_heads, d // cfg.n_heads
        return {"W": L.he_init(gen, (d, d), pd),
                "a_src": L.he_init(gen, (H, dh), pd),
                "a_dst": L.he_init(gen, (H, dh), pd)}
    if cfg.arch == "graphcast":
        return {"edge_mlp": _mlp2_init(gen, 3 * d, d, d, pd),
                "node_mlp": _mlp2_init(gen, 2 * d, d, d, pd),
                "ln_h": torch.ones(d, dtype=pd),
                "ln_e": torch.ones(d, dtype=pd)}
    raise ValueError(cfg.arch)


def _stack(trees):
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return {k: _stack([t[k] for t in trees]) for k in first}


def init(gen: torch.Generator, cfg: GNNConfig) -> Params:
    """The parameter tree on the host, drawn from ``gen``."""
    d, pd = cfg.d_hidden, cfg.param_dtype
    params: Params = {
        "encode": _mlp2_init(gen, cfg.d_in, d, d, pd),
        "decode": _mlp2_init(gen, d, d, cfg.d_out, pd),
        "layers": _stack([_layer_init(gen, cfg)
                          for _ in range(cfg.n_layers)]),
    }
    if cfg.arch in ("gatedgcn", "graphcast"):
        params["edge_encode"] = _mlp2_init(gen, 1, d, d, pd)
    return params


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for v in tree.values() for x in _leaves(v)]


def abstract_params(cfg: GNNConfig) -> "GNN":
    """The model of ``cfg`` on ``meta``: shapes and dtypes, no memory."""
    return GNN(cfg, device="meta")


class GNN(nn.Module):
    """One GNN of :class:`GNNConfig` on ``device`` (``None``: the card; see
    ``csr.resolve_device``), parameters drawn from ``seed`` (on ``meta``:
    shapes and dtypes, nothing drawn)."""

    def __init__(self, cfg: GNNConfig, *, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        if device.type == "meta":  # shapes only: nothing is drawn
            with torch.device("meta"):
                tree = init(torch.Generator(), cfg)
        else:
            tree = init(torch.Generator().manual_seed(seed), cfg)
        for name, sub in tree.items():
            self.add_module(name, L.ParamTree(sub))
        self.to(device)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return forward(self, batch, self.cfg)


# ---------------------------------------------------------------------------
# message-passing layers
# ---------------------------------------------------------------------------

def _egnn_layer(lp, h, x, src, dst, emask, N):
    hi, hj = h[dst], h[src]
    xi, xj = x[dst], x[src]
    d2 = ((xi - xj) ** 2).sum(-1, keepdim=True)
    m = _mlp2(lp["phi_e"], torch.cat([hi, hj, d2], -1))
    m = torch.where(emask[:, None], m, 0.0)
    w = _mlp2(lp["phi_x"], m)
    xupd = _segsum((xi - xj) * w / (d2 + 1.0), dst, N)
    magg = _segsum(m, dst, N)
    h2 = h + _mlp2(lp["phi_h"], torch.cat([h, magg], -1))
    return h2, x + 0.1 * xupd


def _gatedgcn_layer(lp, h, e, src, dst, emask, N):
    eh = (h @ lp["A"])[dst] + (h @ lp["B"])[src] + e @ lp["C"]
    e2 = e + F.silu(L.rms_norm(eh, lp["ln_e"]))
    gate = torch.sigmoid(e2) * emask[:, None]
    vh = (h @ lp["V"])[src]
    num = _segsum(gate * vh, dst, N)
    den = _segsum(gate, dst, N) + 1e-6
    h2 = h + F.silu(L.rms_norm(h @ lp["U"] + num / den, lp["ln_h"]))
    return h2, e2


def _gat_layer(lp, h, src, dst, emask, N, n_heads):
    H = n_heads
    d = h.shape[-1]
    dh = d // H
    z = (h @ lp["W"]).reshape(N, H, dh)
    s_src = torch.einsum("nhd,hd->nh", z, lp["a_src"])
    s_dst = torch.einsum("nhd,hd->nh", z, lp["a_dst"])
    score = F.leaky_relu(s_src[src] + s_dst[dst], 0.2)  # [E, H]
    score = torch.where(emask[:, None], score, -1e30)
    smax = torch.full((N, H), float("-inf"), dtype=score.dtype,
                      device=score.device).scatter_reduce(
        0, dst[:, None].expand(-1, H), score, "amax", include_self=False)
    ex = torch.exp(score - smax[dst]) * emask[:, None]
    den = _segsum(ex, dst, N) + 1e-9
    alpha = ex / den[dst]
    msg = (alpha[..., None] * z[src]).reshape(-1, d)
    out = _segsum(msg, dst, N).reshape(N, H, dh)
    return F.elu(out.reshape(N, d))


def _graphcast_layer(lp, h, e, src, dst, emask, N):
    em = _mlp2(lp["edge_mlp"],
               torch.cat([L.rms_norm(e, lp["ln_e"]), h[src], h[dst]], -1))
    e2 = e + torch.where(emask[:, None], em, 0.0)
    agg = _segsum(e2 * emask[:, None], dst, N)
    h2 = h + _mlp2(lp["node_mlp"],
                   torch.cat([L.rms_norm(h, lp["ln_h"]), agg], -1))
    return h2, e2


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def forward(model: GNN, batch: Dict[str, torch.Tensor], cfg: GNNConfig
            ) -> torch.Tensor:
    feats = batch["feats"].to(cfg.act_dtype)
    src = batch["edge_src"].long()
    dst = batch["edge_dst"].long()
    emask = batch.get("edge_mask")
    if emask is None:
        emask = torch.ones(src.shape[0], dtype=torch.bool,
                           device=src.device)
    N = feats.shape[0]
    h = _mlp2(model.encode, feats)
    layers = model.layers

    if cfg.arch == "egnn":
        x = batch["coords"].to(cfg.act_dtype)
        for i in range(cfg.n_layers):
            h, x = _egnn_layer(L.layer_slice(layers, i), h, x, src, dst,
                               emask, N)
    elif cfg.arch in ("gatedgcn", "graphcast"):
        dist = batch.get("edge_feats")
        if dist is None:
            dist = torch.ones((src.shape[0], 1), dtype=cfg.act_dtype,
                              device=src.device)
        e = _mlp2(model.edge_encode, dist.to(cfg.act_dtype))
        layer = _gatedgcn_layer if cfg.arch == "gatedgcn" \
            else _graphcast_layer
        for i in range(cfg.n_layers):
            h, e = layer(L.layer_slice(layers, i), h, e, src, dst, emask,
                         N)
    elif cfg.arch == "gat":
        for i in range(cfg.n_layers):
            h = _gat_layer(L.layer_slice(layers, i), h, src, dst, emask, N,
                           cfg.n_heads)
    else:
        raise ValueError(cfg.arch)

    if cfg.task == "graph_reg":
        gid = batch["graph_id"]
        G = int(batch["labels"].shape[0])
        pooled = _segsum(h, gid, G)
        return _mlp2(model.decode, pooled)  # [G, d_out]
    return _mlp2(model.decode, h)  # [N, d_out]


def loss_fn(model: GNN, batch: Dict[str, torch.Tensor], cfg: GNNConfig
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    out = forward(model, batch, cfg)
    mask = batch.get("label_mask")
    if cfg.task == "node_class":
        labels = batch["labels"].long()
        lg = out.to(torch.float32)
        lse = torch.logsumexp(lg, -1)
        gold = torch.gather(lg, 1, labels[:, None])[:, 0]
        per = lse - gold
        if mask is not None:
            per = torch.where(mask, per, 0.0)
            denom = mask.sum().clamp(min=1)
            loss = per.sum() / denom
        else:
            loss = per.mean()
        acc = lg.argmax(-1) == labels
        acc = ((acc & mask).sum() / mask.sum().clamp(min=1)) \
            if mask is not None else acc.to(torch.float32).mean()
        return loss, {"acc": acc.detach()}
    # regression (node or graph)
    err = (out.to(torch.float32)
           - batch["labels"].to(torch.float32)) ** 2
    if mask is not None and cfg.task == "node_reg":
        err = torch.where(mask[:, None], err, 0.0)
        loss = err.sum() / (mask.sum() * out.shape[-1]).clamp(min=1)
    else:
        loss = err.mean()
    return loss, {"mse": loss.detach()}
