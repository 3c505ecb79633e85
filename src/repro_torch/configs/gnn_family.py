"""GNN-family ArchSpec builder: the four assigned graph shapes.

Shapes span three execution regimes: full-batch small (cora), sampled
minibatch (reddit-scale: the neighbor-sampler blocks flattened to one padded
union graph), full-batch large (ogbn-products), and batched small graphs
(molecule).  One padded-graph convention serves all (models/gnn.py).

Each shape is a dry-run train cell: the full update step on ``meta``
(``launch.dryrun``), node and edge counts padded to multiples of 512 so
that the production mesh's axes divide them, probed at depths 1 and 2.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec, Cell
from repro_torch.core.csr import resolve_device
from repro_torch.models import gnn as G
from repro_torch.optim import adamw_init, adamw_update, cosine_decay
from repro_torch.optim.adamw import AdamWState

# (name, dict) — node/edge counts from the assignment; d_feat/classes from
# the public datasets these shapes correspond to (cora / reddit / products).
SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          n_classes=7, kind="train"),
    "minibatch_lg": dict(n_nodes=164_864, n_edges=163_840, d_feat=602,
                         n_classes=41, kind="train",
                         note="1024 seeds x fanout 15-10 union graph of the"
                              " 232,965-node graph"),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                         n_classes=47, kind="train"),
    "molecule": dict(n_nodes=30 * 128, n_edges=64 * 128, d_feat=16,
                     n_graphs=128, kind="train"),
}


def _shape_cfg(base: G.GNNConfig, shape: Dict) -> G.GNNConfig:
    """Bind d_in/d_out/task to the dataset shape."""
    task = base.task
    if "n_graphs" in shape:
        task = "graph_reg"
        d_out = 1
    elif task == "node_class":
        d_out = shape["n_classes"]
    else:
        d_out = base.d_out
    return dataclasses.replace(base, d_in=shape["d_feat"], d_out=d_out,
                               task=task)


def make_train_step(cfg: G.GNNConfig, schedule=None):
    """``train_step(model, opt, batch) -> metrics``: loss, autograd and one
    AdamW update, in place on the model's parameters and ``opt``."""
    sched = schedule or cosine_decay(1e-3, 100, 10_000)

    def train_step(model, opt, batch):
        model.zero_grad(set_to_none=True)
        loss, metrics = G.loss_fn(model, batch, cfg)
        loss.backward()
        params = dict(model.named_parameters())
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.items()}
        adamw_update(params, grads, opt, lr=sched(opt.step),
                     weight_decay=0.0)
        return {"loss": loss.detach(), **metrics}

    return train_step


def _abstract_batch(cfg: G.GNNConfig, shape: Dict):
    """The shape's batch on ``meta`` and its logical axes.  Node and edge
    counts are padded to multiples of 512 (the 2x16x16 mesh's size); the
    assignment's exact counts ride in the masks.  Without the padding,
    odd counts (2,449,029 nodes) defeat every sharding rule and the graph
    is replicated on every device."""
    N = -(-shape["n_nodes"] // 512) * 512
    E = -(-shape["n_edges"] // 512) * 512

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    batch = {
        "feats": meta((N, shape["d_feat"]), torch.float32),
        "edge_src": meta((E,), torch.int32),
        "edge_dst": meta((E,), torch.int32),
        "edge_mask": meta((E,), torch.bool),
        "label_mask": meta((N,), torch.bool),
    }
    axes = {
        "feats": ("nodes", None), "edge_src": ("edges",),
        "edge_dst": ("edges",), "edge_mask": ("edges",),
        "label_mask": ("nodes",),
    }
    if cfg.arch == "egnn":
        batch["coords"] = meta((N, 3), torch.float32)
        axes["coords"] = ("nodes", None)
    if cfg.arch in ("gatedgcn", "graphcast"):
        batch["edge_feats"] = meta((E, 1), torch.float32)
        axes["edge_feats"] = ("edges", None)
    if cfg.task == "graph_reg":
        batch["graph_id"] = meta((N,), torch.int32)
        batch["labels"] = meta((shape["n_graphs"], 1), torch.float32)
        axes["graph_id"] = ("nodes",)
        axes["labels"] = ("batch", None)
    elif cfg.task == "node_class":
        batch["labels"] = meta((N,), torch.int32)
        axes["labels"] = ("nodes",)
    else:
        batch["labels"] = meta((N, cfg.d_out), torch.float32)
        axes["labels"] = ("nodes", None)
    return batch, axes


def _param_axes_like(model) -> Dict:
    """Every parameter replicated, by dotted name."""
    return {k: (None,) * p.dim() for k, p in model.named_parameters()}


def smoke_batch(cfg: G.GNNConfig, device=None):
    """The smoke run's config (d_in 8) and its random 40-node, 160-edge
    batch (numpy seed 0) on ``device``."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    N, E = 40, 160
    cfg = dataclasses.replace(cfg, d_in=8,
                              d_out=3 if cfg.task == "node_class"
                              else cfg.d_out)
    batch = {
        "feats": rng.normal(size=(N, 8)).astype(np.float32),
        "coords": rng.normal(size=(N, 3)).astype(np.float32),
        "edge_src": rng.integers(0, N, E).astype(np.int32),
        "edge_dst": rng.integers(0, N, E).astype(np.int32),
        "edge_mask": np.ones(E, bool),
        "edge_feats": rng.normal(size=(E, 1)).astype(np.float32),
        "label_mask": np.ones(N, bool),
    }
    if cfg.task == "node_class":
        batch["labels"] = rng.integers(0, 3, N).astype(np.int32)
    elif cfg.task == "graph_reg":
        batch["graph_id"] = rng.integers(0, 4, N).astype(np.int32)
        batch["labels"] = rng.normal(size=(4, 1)).astype(np.float32)
    else:
        batch["labels"] = rng.normal(size=(N, cfg.d_out)).astype(np.float32)
    return cfg, {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def gnn_arch(arch_id: str, describe: str, base: G.GNNConfig,
             smoke: G.GNNConfig) -> ArchSpec:
    cells: Dict[str, Cell] = {}
    for name, shape in SHAPES.items():
        def build(mesh=None, shape=shape, cfg=None):
            cfg = cfg or _shape_cfg(base, shape)
            model = G.abstract_params(cfg)
            opt = adamw_init(model)
            batch, baxes = _abstract_batch(cfg, shape)
            p_ax = _param_axes_like(model)
            axes = (p_ax, AdamWState((), p_ax, p_ax), baxes)
            return make_train_step(cfg), (model, opt, batch), axes, (0, 1)

        def probe(mesh, depth, shape=shape, build=build):
            return build(mesh, cfg=dataclasses.replace(
                _shape_cfg(base, shape), n_layers=depth))

        cells[name] = Cell(name, "train", build, None, probe, (1, 2),
                           base.n_layers)

    def smoke_run(cfg=None, device=None):
        cfg, batch = smoke_batch(cfg or smoke, device)
        model = G.GNN(cfg, seed=0, device=device)
        opt = adamw_init(model)
        step = make_train_step(cfg)
        losses = []
        for _ in range(3):
            m = step(model, opt, batch)
            losses.append(float(m["loss"]))
        if not all(np.isfinite(l) for l in losses):
            raise AssertionError(f"non-finite smoke losses {losses}")
        if not losses[-1] < losses[0] * 1.5 + 1.0:
            raise AssertionError(f"smoke loss diverged: {losses}")
        return {"loss_first": losses[0], "loss_last": losses[-1]}

    def model_flops(shape_name: str) -> float:
        shape = SHAPES[shape_name]
        cfg = _shape_cfg(base, shape)
        d, L = cfg.d_hidden, cfg.n_layers
        N, E = shape["n_nodes"], shape["n_edges"]
        ce = {"egnn": 4, "gatedgcn": 3, "gat": 2, "graphcast": 8}[cfg.arch]
        cn = {"egnn": 6, "gatedgcn": 6, "gat": 2, "graphcast": 6}[cfg.arch]
        per_step = (N * cfg.d_in * d + L * (E * ce * d * d
                                            + N * cn * d * d)
                    + N * d * cfg.d_out)
        return 6.0 * per_step  # fwd+bwd

    return ArchSpec(arch_id, "gnn", describe, base, smoke, cells,
                    smoke_run, model_flops)


EGNN = gnn_arch(
    "egnn", "4L d64 E(n)-equivariant [arXiv:2102.09844; paper]",
    G.GNNConfig("egnn", "egnn", 4, 64, d_in=16, d_out=1, task="node_reg"),
    G.GNNConfig("egnn-smoke", "egnn", 2, 16, d_in=8, d_out=1,
                task="node_reg"))

GRAPHCAST = gnn_arch(
    "graphcast", "16L d512 mesh-GNN encoder-processor-decoder, sum "
    "aggregator, n_vars=227 [arXiv:2212.12794; unverified] — applied to the "
    "assigned generic graph shapes (see DESIGN.md)",
    G.GNNConfig("graphcast", "graphcast", 16, 512, d_in=227, d_out=227,
                task="node_reg"),
    G.GNNConfig("graphcast-smoke", "graphcast", 2, 16, d_in=8, d_out=4,
                task="node_reg"))

GATEDGCN = gnn_arch(
    "gatedgcn", "16L d70 gated aggregator [arXiv:2003.00982; paper]",
    G.GNNConfig("gatedgcn", "gatedgcn", 16, 70, d_in=16, d_out=7,
                task="node_class"),
    G.GNNConfig("gatedgcn-smoke", "gatedgcn", 2, 16, d_in=8, d_out=3,
                task="node_class"))

GAT_CORA = gnn_arch(
    "gat-cora", "2L d_hidden 8x8 heads attention aggregator "
    "[arXiv:1710.10903; paper]",
    G.GNNConfig("gat-cora", "gat", 2, 64, d_in=1433, d_out=7, n_heads=8,
                task="node_class", aggregator="attn"),
    G.GNNConfig("gat-smoke", "gat", 2, 16, d_in=8, d_out=3, n_heads=4,
                task="node_class", aggregator="attn"))
