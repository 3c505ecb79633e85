"""Train a ~100M-parameter LM for a few hundred steps on the PyTorch/CUDA
port: the twin of ``examples/train_lm.py``.

Exercises the full training substrate end-to-end: model, AdamW + cosine
schedule, deterministic restartable data pipeline, atomic checkpoints.
Runs on the card unless ``--device cpu``; ``--d-model``, ``--layers``
and ``--vocab`` shrink the model (heads of 64 dims, a third of them KV
heads, ff = 8d/3: the defaults are the JAX example's 768, 8 and 32,768).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.lm_family import make_train_step, token_batch
from repro_torch.core.csr import resolve_device
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.train import train_state
from repro_torch.models.transformer import Transformer, TransformerConfig
from repro_torch.optim import adamw_init, cosine_decay


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_lm100m"))
    args = ap.parse_args(argv)
    device = resolve_device(device or args.device)

    # ~100M params: 8L x 768d x 12H (4 KV), 32k vocab (tied embeddings)
    heads = max(args.d_model // 64, 1)
    cfg = TransformerConfig(
        "lm-100m", num_layers=args.layers, d_model=args.d_model,
        n_heads=heads, n_kv_heads=max(heads // 3, 1),
        head_dim=args.d_model // heads, d_ff=8 * args.d_model // 3,
        vocab=args.vocab, param_dtype=torch.float32,
        act_dtype=torch.float32)
    model = Transformer(cfg, seed=0, device=device)
    n = sum(p.numel() for p in model.parameters())
    print(f"model: {n / 1e6:.1f}M params on {device}")

    opt = adamw_init(model)
    sched = cosine_decay(3e-4, 20, args.steps)
    step_fn = make_train_step(cfg, schedule=sched)
    ts = TokenStream(cfg.vocab, args.batch, args.seq, seed=0)
    mgr = CheckpointManager(args.ckpt_dir, keep_last=2)

    t0, losses = time.time(), []
    for s in range(args.steps):
        m = step_fn(model, opt, token_batch(ts.batch_at(s), device))
        losses.append(float(m["loss"]))
        if (s + 1) % 20 == 0:
            dt = time.time() - t0
            print(f"step {s + 1:4d} loss {losses[-1]:.4f} "
                  f"({args.batch * args.seq * 20 / dt:,.0f} tok/s)")
            t0 = time.time()
        if (s + 1) % 100 == 0:
            mgr.save(train_state(model, opt), s + 1)
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved ✓' if last < first else 'no improvement ✗'})")
    assert last < first
    return losses


if __name__ == "__main__":
    main()
