"""LM-family ArchSpec: the serving and training shapes of the assigned
LM archs as dry-run cells, their training step with gradient
accumulation, the smoke run and the analytic model FLOPs.

A train cell is the full update step (forward, backward, AdamW; the
model and optimizer state donated), a prefill cell the prefill, a decode
cell one decode step against the cache (donated), each built on ``meta``
by :func:`train_cell`, :func:`prefill_cell` and :func:`decode_cell`,
which take a real device too (the card's check of the dry run's counts).
Dense archs train pure data-parallel (``batch_dp3``, one microbatch), MoE
archs keep their microbatches, as the JAX package's cells do.  The depth
probes keep each cell's microbatches: the port's meta run counts every
one, where XLA's cost analysis counted a scan body once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec, Cell
from repro_torch.core.csr import resolve_device
from repro_torch.distributed.sharding import dotted_axes
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update, cosine_decay
from repro_torch.optim.adamw import AdamWState

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256, microbatches=8),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, shard_seq=True),
}


LONG_SKIP = ("pure full-attention architecture: 524k dense attention "
             "is out of assignment scope (see DESIGN.md §4)")


def _batch_axes(pure_dp=False):
    name = "batch_dp3" if pure_dp else "batch"
    return {"tokens": (name, None), "labels": (name, None)}


def _opt_axes(params_axes):
    """The optimizer state's axes: its moments by dotted parameter name."""
    flat = dotted_axes(params_axes)
    return AdamWState((), flat, flat)


def _model(cfg: T.TransformerConfig, device, seed: int):
    device = torch.device(device)
    if device.type == "meta":
        return T.abstract_params(cfg)
    return T.Transformer(cfg, seed=seed, device=device)


def _tokens(shape, vocab: int, device, seed: int) -> torch.Tensor:
    """int32 token ids of ``shape``: empty on meta, else uniform from
    numpy ``seed``."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.int32, device=device)
    ids = np.random.default_rng(seed).integers(0, vocab, shape)
    return torch.from_numpy(ids.astype(np.int32)).to(device)


def train_cell(cfg: T.TransformerConfig, shape: Dict, device="meta",
               seed: int = 0):
    """(step, (model, opt, batch), axes, donate) of a train cell: dense
    archs one microbatch over ``batch_dp3``, MoE archs
    ``shape["microbatches"]`` over ``batch``."""
    pure = not cfg.is_moe
    M = 1 if pure else shape.get("microbatches", 1)
    model = _model(cfg, device, seed)
    opt = adamw_init(model)
    B, S = shape["batch"], shape["seq"]
    batch = {"tokens": _tokens((B, S), cfg.vocab, device, seed),
             "labels": _tokens((B, S), cfg.vocab, device, seed + 1)}
    p_ax = T.logical_axes(cfg)
    axes = (p_ax, _opt_axes(p_ax), _batch_axes(pure))
    return make_train_step(cfg, microbatches=M), (model, opt, batch), \
        axes, (0, 1)


def prefill_cell(cfg: T.TransformerConfig, shape: Dict, device="meta",
                 seed: int = 0):
    """(step, (model, tokens), axes, donate) of a prefill cell."""
    model = _model(cfg, device, seed)
    tokens = _tokens((shape["batch"], shape["seq"]), cfg.vocab, device,
                     seed)
    return T.prefill, (model, tokens), \
        (T.logical_axes(cfg), ("batch", None)), ()


def decode_cell(cfg: T.TransformerConfig, shape: Dict, device="meta",
                seed: int = 0):
    """(step, (model, cache, tokens, pos), axes, donate) of a decode
    cell: one step at the last position of a full cache (``pos`` = seq -
    1, an int; the JAX cell's is an abstract int32), the cache donated."""
    model = _model(cfg, device, seed)
    B, S = shape["batch"], shape["seq"]
    if torch.device(device).type == "meta":
        cache = T.abstract_cache(cfg, B, S)
    else:
        cache = T.make_cache(cfg, B, S, device=device)
    tokens = _tokens((B, 1), cfg.vocab, device, seed)
    axes = (T.logical_axes(cfg), T.cache_logical_axes(cfg),
            ("batch", None), ())
    return T.decode_step, (model, cache, tokens, S - 1), axes, (1,)


CELL_OF = {"train": train_cell, "prefill": prefill_cell,
           "decode": decode_cell}


def make_train_step(cfg: T.TransformerConfig, schedule=None,
                    microbatches: int = 1):
    """``train_step(model, opt, batch) -> metrics``: the full update step,
    in place on the model's parameters and ``opt``.  ``microbatches`` M >
    1 splits the batch into M microbatches along its first axis and
    accumulates their gradients in f32, divided by M, with the loss
    averaged; with M = 1 the gradients keep the parameters' dtype.  Each
    microbatch is its own MoE dispatch, so the capacity is a
    microbatch's.  Metrics: ``loss``, ``gnorm`` (pre-clip) and, with M =
    1, ``ce`` and ``aux``."""
    sched = schedule or cosine_decay(3e-4, 2000, 100_000)

    def grads_of(model, batch):
        loss, metrics = T.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss.detach(), metrics, grads

    def train_step(model, opt, batch):
        names = [k for k, _ in model.named_parameters()]
        if microbatches == 1:
            loss, metrics, grads = grads_of(model, batch)
            grads = dict(zip(names, grads))
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            M = microbatches
            gacc = {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in model.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(model.parameters()).device)
            for i in range(M):
                mb = {k: v.reshape((M, v.shape[0] // M) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, _, g = grads_of(model, mb)
                for k, gi in zip(names, g):
                    gacc[k].add_(gi)
                del g
                loss = loss + l
            grads = {k: g.div_(M) for k, g in gacc.items()}
            loss = loss / M
            metrics = {}
        gnorm = adamw_update(model, grads, opt, lr=sched(opt.step))
        return {"loss": loss, "gnorm": gnorm, **metrics}

    return train_step


def token_batch(b: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """A ``TokenStream`` batch [B, S + 1] as inputs and next-token labels
    on ``device``."""
    return {"tokens": torch.from_numpy(b[:, :-1].copy()).to(device),
            "labels": torch.from_numpy(b[:, 1:].copy()).to(device)}


def lm_arch(arch_id: str, describe: str, full: T.TransformerConfig,
            smoke: T.TransformerConfig) -> ArchSpec:
    cells: Dict[str, Cell] = {}
    period = max(full.local_global_period, 1)
    for name, shape in SHAPES.items():
        kind = shape["kind"]
        skip = LONG_SKIP if name == "long_500k" and \
            not full.sub_quadratic else None
        make = CELL_OF[kind]

        def build(mesh=None, make=make, shape=shape):
            return make(full, shape)

        def probe(mesh, depth, make=make, shape=shape):
            return make(dataclasses.replace(full, num_layers=depth), shape)

        cells[name] = Cell(name, kind, build, skip, probe,
                           (period, 2 * period), full.num_layers)

    def smoke_run(cfg=None, device=None):
        """Two train steps of ``cfg`` (the smoke config) on ``TokenStream``
        batches, then a decode step's shape check."""
        from repro_torch.data.synthetic import TokenStream
        cfg = cfg or smoke
        device = resolve_device(device)
        model = T.Transformer(cfg, seed=0, device=device)
        opt = adamw_init(model)
        step = make_train_step(cfg)
        ts = TokenStream(cfg.vocab, 2, 32, seed=0)
        losses = []
        for s in range(2):
            m = step(model, opt, token_batch(ts.batch_at(s), device))
            losses.append(float(m["loss"]))
        if not all(np.isfinite(l) for l in losses):
            raise AssertionError(f"non-finite smoke losses {losses}")
        cache = T.make_cache(cfg, 1, 16, device=device)
        lg, _ = T.decode_step(model, cache, torch.zeros(
            (1, 1), dtype=torch.int32, device=device), 0)
        if tuple(lg.shape) != (1, cfg.vocab) \
                or not bool(torch.isfinite(lg.float()).all()):
            raise AssertionError(f"decode logits {tuple(lg.shape)} not "
                                 f"finite of shape (1, {cfg.vocab})")
        return {"loss_first": losses[0], "loss_last": losses[-1]}

    def model_flops(shape_name: str) -> float:
        shape = SHAPES[shape_name]
        n_active = full.active_param_count()
        tokens = shape["batch"] * (shape["seq"]
                                   if shape["kind"] != "decode" else 1)
        factor = 6.0 if shape["kind"] == "train" else 2.0
        return factor * n_active * tokens

    return ArchSpec(arch_id, "lm", describe, full, smoke, cells,
                    smoke_run, model_flops)
