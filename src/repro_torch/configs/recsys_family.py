"""Two-tower recsys ArchSpec: train / online / bulk / retrieval cells.

Each is a dry-run cell on ``meta`` (``launch.dryrun``): the full update
step, with parameters and optimizer state donated, or the serving and
retrieval passes (no autograd).
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec, Cell
from repro_torch.core.csr import resolve_device
from repro_torch.distributed.sharding import dotted_axes
from repro_torch.models import recsys as R
from repro_torch.optim import adamw_init, adamw_update, cosine_decay
from repro_torch.optim.adamw import AdamWState

SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}


def _feat_specs(cfg: R.TwoTowerConfig, B: int):
    feats = {name: torch.empty((B, cfg.multi_hot), dtype=torch.int32,
                               device="meta")
             for name, _ in cfg.user_tables}
    axes = {name: ("batch", None) for name, _ in cfg.user_tables}
    return feats, axes


def _ids(n: int) -> torch.Tensor:
    return torch.empty((n,), dtype=torch.int32, device="meta")


def make_train_step(cfg: R.TwoTowerConfig, schedule=None):
    """``train_step(params, opt, batch) -> metrics``: the sampled-softmax
    loss, autograd and one AdamW update (no weight decay), in place on
    ``params`` and ``opt``; the metrics carry the pre-clip gradient
    norm."""
    sched = schedule or cosine_decay(1e-3, 500, 50_000)

    def train_step(params, opt, batch):
        params.zero_grad(set_to_none=True)
        loss, metrics = R.loss_fn(params, batch, cfg)
        loss.backward()
        named = dict(params.named_parameters())
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in named.items()}
        gnorm = adamw_update(named, grads, opt, lr=sched(opt.step),
                             weight_decay=0.0)
        return {"loss": loss.detach(), "grad_norm": gnorm, **metrics}

    return train_step


def event_batch(cfg: R.TwoTowerConfig, batch: int, step: int, device,
                seed: int = 0) -> Dict:
    """One ``recsys_events`` batch as the model's input on ``device``:
    each table's bag ids modulo its rows, and the item ids."""
    from repro_torch.data.synthetic import recsys_events
    feats, items, _ = recsys_events(
        1000, cfg.num_items, batch, step,
        tuple(r for _, r in cfg.user_tables), multi_hot=cfg.multi_hot,
        seed=seed)
    return {"feats": {name: torch.from_numpy(feats[f"table_{i}"] % rows)
                      .to(device)
                      for i, (name, rows) in enumerate(cfg.user_tables)},
            "item_ids": torch.from_numpy(items).to(device)}


def recsys_arch(arch_id: str, describe: str, full: R.TwoTowerConfig,
                smoke: R.TwoTowerConfig) -> ArchSpec:
    def build_train(mesh=None):
        cfg = full
        params = R.abstract_params(cfg)
        opt = adamw_init(params)
        B = SHAPES["train_batch"]["batch"]
        feats, faxes = _feat_specs(cfg, B)
        batch = {"feats": feats, "item_ids": _ids(B)}
        baxes = {"feats": faxes, "item_ids": ("batch",)}
        p_ax = R.logical_axes(cfg)
        flat = dotted_axes(p_ax)
        axes = (p_ax, AdamWState((), flat, flat), baxes)
        return make_train_step(cfg), (params, opt, batch), axes, (0, 1)

    def build_serve(B):
        def build(mesh=None):
            cfg = full
            feats, faxes = _feat_specs(cfg, B)
            axes = (R.logical_axes(cfg), faxes, ("batch",))
            step = torch.no_grad()(functools.partial(R.serve_scores,
                                                     cfg=cfg))
            return step, (R.abstract_params(cfg), feats, _ids(B)), axes, ()
        return build

    def build_retrieval(mesh=None):
        cfg = full
        C = SHAPES["retrieval_cand"]["n_candidates"]
        feats, faxes = _feat_specs(cfg, 1)
        axes = (R.logical_axes(cfg), faxes, ("candidates",))
        step = torch.no_grad()(functools.partial(R.retrieval_topk, cfg=cfg))
        return step, (R.abstract_params(cfg), feats, _ids(C)), axes, ()

    cells = {
        "train_batch": Cell("train_batch", "train", build_train),
        "serve_p99": Cell("serve_p99", "serve", build_serve(512)),
        "serve_bulk": Cell("serve_bulk", "serve", build_serve(262_144)),
        "retrieval_cand": Cell("retrieval_cand", "retrieval",
                               build_retrieval),
    }

    def smoke_run(cfg=None, device=None):
        cfg = cfg or smoke
        device = resolve_device(device)
        params = R.init(cfg, seed=0, device=device)
        opt = adamw_init(params)
        step = make_train_step(cfg)
        losses = []
        for s in range(3):
            batch = event_batch(cfg, 64, s, device)
            m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        if not all(np.isfinite(l) for l in losses):
            raise AssertionError(f"non-finite smoke losses {losses}")
        # the retrieval path
        with torch.no_grad():
            vals, _ = R.retrieval_topk(
                params, {k: v[:1] for k, v in batch["feats"].items()},
                torch.arange(cfg.num_items, dtype=torch.int32,
                             device=device), cfg, k=10)
        if not bool(torch.isfinite(vals).all()):
            raise AssertionError("non-finite retrieval scores")
        return {"loss_first": losses[0], "loss_last": losses[-1]}

    def model_flops(shape_name: str) -> float:
        cfg = full
        shape = SHAPES[shape_name]
        din_u = cfg.embed_dim * len(cfg.user_tables)
        mlp_u = sum(a * b for a, b in zip(
            (din_u,) + cfg.tower_mlp[:-1], cfg.tower_mlp))
        mlp_i = sum(a * b for a, b in zip(
            (cfg.embed_dim,) + cfg.tower_mlp[:-1], cfg.tower_mlp))
        if shape_name == "train_batch":
            B = shape["batch"]
            score = B * cfg.num_negatives * cfg.tower_mlp[-1]
            return 6.0 * (B * (mlp_u + mlp_i) + score)
        if shape_name == "retrieval_cand":
            C = shape["n_candidates"]
            return 2.0 * (mlp_u + C * mlp_i + C * cfg.tower_mlp[-1])
        B = shape["batch"]
        return 2.0 * B * (mlp_u + mlp_i + cfg.tower_mlp[-1])

    return ArchSpec(arch_id, "recsys", describe, full, smoke, cells,
                    smoke_run, model_flops)


TWO_TOWER = recsys_arch(
    "two-tower-retrieval",
    "embed 256, towers 1024-512-256, dot interaction, sampled softmax "
    "[RecSys'19 (YouTube); unverified]",
    R.TwoTowerConfig(),
    R.TwoTowerConfig(name="two-tower-smoke",
                     user_tables=(("user_id", 1000), ("hist_items", 500),
                                  ("context", 100)),
                     num_items=2000, embed_dim=32, tower_mlp=(64, 32, 16),
                     num_negatives=32))
