"""Fault-tolerant training:
``python -m repro_torch.launch.train --arch mixtral-8x7b``.

The JAX package's ``launch/train.py`` on the card.  The LM family
(:func:`train_lm`) trains the smoke config (``--full``: the assigned
one) on ``TokenStream`` batches with checkpoint/restart, logging tok/s.
A recsys arch (``two-tower-retrieval``) runs its smoke config's
``smoke_run`` (three steps and a retrieval), as the JAX package does, and
so does ``wcoj-subgraph`` (the distributed triangle count of an R-MAT
scale-9 graph on one worker, held to Generic Join's); the driver prints
the smoke run's metrics and the kernel launches it made.
The GNN family:
  * motif features — per-vertex triangle counts from the port's BiGJoin
    (on the card), appended to the node features;
  * minibatches — GraphSAGE blocks from the neighbor sampler, flattened
    to one padded union graph (:func:`union_batch`);
  * checkpoint/restart — atomic checkpoints every --ckpt-every steps;
    relaunching the same command resumes from the newest intact one
    (a crash during a write leaves only skippable partial state).

The GNN driver runs the smoke config of the arch whatever ``--full``
says, as the JAX package's does.  ``device`` (a function
argument, ``None``: the card) lets tests run it on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.csr import resolve_device


def union_batch(blocks: List, seeds: np.ndarray, feats: np.ndarray,
                labels: np.ndarray, n_max: int, e_max: int, device
                ) -> Dict[str, torch.Tensor]:
    """Sampler blocks (outermost first) flattened to one union graph over
    the outermost block's source nodes, padded to ``n_max`` nodes and
    ``e_max`` edges (truncated when larger), with the labels of the seeds
    alone counted (``label_mask``)."""
    nodes = blocks[0].src_nodes  # sorted, unique
    es = np.concatenate([b.src_nodes[b.edge_src] for b in blocks])
    ed = np.concatenate([b.dst_nodes[b.edge_dst] for b in blocks])
    es = np.searchsorted(nodes, es).astype(np.int32)
    ed = np.searchsorted(nodes, ed).astype(np.int32)
    n, e = len(nodes), len(es)
    if n > n_max or e > e_max:
        n, e = min(n, n_max), min(e, e_max)
    label_mask = np.isin(nodes[:n], seeds) if n else np.zeros(0, bool)
    batch = {
        "feats": np.pad(feats[nodes][:n], ((0, n_max - n), (0, 0))),
        "coords": np.zeros((n_max, 3), np.float32),
        "edge_src": np.pad(es[:e], (0, e_max - e)),
        "edge_dst": np.pad(ed[:e], (0, e_max - e)),
        "edge_mask": np.arange(e_max) < e,
        "edge_feats": np.ones((e_max, 1), np.float32),
        "labels": np.pad(labels[nodes][:n], (0, n_max - n)),
        "label_mask": np.pad(label_mask, (0, n_max - n)),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def train_state(model, opt) -> dict:
    """The checkpointed state: parameters and AdamW moments by name, and
    the step counter."""
    return {"params": {k: p.detach() for k, p in model.named_parameters()},
            "opt": {"step": opt.step, "mu": opt.mu, "nu": opt.nu}}


def load_state(model, opt, state: dict) -> None:
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(state["params"][k])
    opt.step = int(state["opt"]["step"])
    for k in opt.mu:
        opt.mu[k].copy_(state["opt"]["mu"][k])
        opt.nu[k].copy_(state["opt"]["nu"][k])


def _restore(mgr, model, opt) -> int:
    """Load the newest intact checkpoint into ``model`` and ``opt``;
    returns its step (0 without one)."""
    restored = mgr.restore_latest(train_state(model, opt))
    if restored is None:
        return 0
    state, manifest = restored
    load_state(model, opt, state)
    print(f"resumed from step {manifest['step']}")
    return manifest["step"]


def train_lm(spec, args, device=None) -> float:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.lm_family import make_train_step, token_batch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init

    device = resolve_device(device)
    cfg = spec.full_config if args.full else spec.smoke_config
    model = T.Transformer(cfg, seed=args.seed, device=device)
    opt = adamw_init(model)
    step_fn = make_train_step(cfg)
    mgr = CheckpointManager(args.ckpt_dir, keep_last=3)
    start = _restore(mgr, model, opt)

    ts = TokenStream(cfg.vocab, args.batch, args.seq, seed=args.seed)
    t0 = time.time()
    m = None
    for s in range(start, args.steps):
        m = step_fn(model, opt, token_batch(ts.batch_at(s), device))
        if (s + 1) % args.log_every == 0:
            loss = float(m["loss"])  # waits for the step
            dt = (time.time() - t0) / args.log_every
            print(f"step {s+1} loss {loss:.4f} gnorm "
                  f"{float(m['gnorm']):.3f} "
                  f"{args.batch * args.seq / dt:,.0f} tok/s", flush=True)
            t0 = time.time()
        if (s + 1) % args.ckpt_every == 0 or s + 1 == args.steps:
            mgr.save(train_state(model, opt), s + 1,
                     extra={"loss": float(m["loss"])})
    return float(m["loss"])


def train_gnn(spec, args, device=None) -> float:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.gnn_family import make_train_step
    from repro_torch.core.csr import Graph
    from repro_torch.data.graph_sampler import NeighborSampler
    from repro_torch.data.motifs import motif_features
    from repro_torch.data.synthetic import uniform_graph
    from repro_torch.models import gnn as G
    from repro_torch.optim import adamw_init

    device = resolve_device(device)
    base = spec.smoke_config
    edges = uniform_graph(args.nodes, args.nodes * 8, seed=args.seed)
    graph = Graph.from_edges(edges, args.nodes)
    rng = np.random.default_rng(args.seed)
    # WCOJ motif features from the paper's engine
    motifs = motif_features(graph, ("triangle",), device=device)
    feats = np.concatenate(
        [rng.normal(size=(args.nodes, 8)).astype(np.float32), motifs], 1)
    labels = (motifs[:, 0] > np.median(motifs[:, 0])).astype(np.int32)
    cfg = dataclasses.replace(base, d_in=feats.shape[1], d_out=2)
    model = G.GNN(cfg, seed=args.seed, device=device)
    opt = adamw_init(model)
    step_fn = make_train_step(cfg)
    sampler = NeighborSampler(edges, args.nodes)

    mgr = CheckpointManager(args.ckpt_dir, keep_last=3)
    start = _restore(mgr, model, opt)

    N_max, E_max = 512, 2048
    m = None
    for s in range(start, args.steps):
        srng = np.random.default_rng(args.seed * 7919 + s)
        seeds = srng.choice(args.nodes, 64, replace=False)
        blocks = sampler.sample_blocks(seeds, [5, 5], seed=args.seed + s)
        batch = union_batch(blocks, seeds, feats, labels, N_max, E_max,
                            device)
        m = step_fn(model, opt, batch)
        if (s + 1) % args.log_every == 0:
            print(f"step {s+1} loss {float(m['loss']):.4f} "
                  f"acc {float(m.get('acc', 0)):.3f}", flush=True)
        if (s + 1) % args.ckpt_every == 0 or s + 1 == args.steps:
            mgr.save(train_state(model, opt), s + 1)
    return float(m["loss"])


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--nodes", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=5)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    spec = get_arch(args.arch)  # KeyError for an arch the port lacks
    if spec.family == "lm":
        loss = train_lm(spec, args, device)
    elif spec.family == "gnn":
        loss = train_gnn(spec, args, device)
    else:
        from repro_torch import kernels
        kernels.reset_launches()
        m = spec.smoke_run(spec.smoke_config, device=device)
        print(f"smoke {json.dumps(m)} launches "
              f"{json.dumps(kernels.launches())}", flush=True)
        loss = m.get("loss_last", 0.0)
    print(f"final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
