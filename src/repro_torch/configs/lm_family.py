"""LM-family ArchSpec: the serving and training shapes of the assigned
LM archs, their training step with gradient accumulation, the smoke run
and the analytic model FLOPs.

The JAX package's abstract dry-run cells (lowering a step over a fake
device mesh) are not carried over (``configs/base.py``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.core.csr import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update, cosine_decay

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256, microbatches=8),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, shard_seq=True),
}


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

    return ArchSpec(arch_id, "lm", describe, full, smoke, smoke_run,
                    model_flops)
