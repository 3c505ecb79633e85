"""Learning-rate schedules (pure functions of the int step counter),
computed in float32 as the JAX package computes them."""
from __future__ import annotations

import numpy as np


def constant(lr: float):
    return lambda step: np.float32(lr)


def linear_warmup(base: float, warmup_steps: int):
    def fn(step):
        frac = np.minimum(np.float32(step) / np.float32(max(warmup_steps,
                                                             1)),
                          np.float32(1.0))
        return np.float32(base) * frac
    return fn


def cosine_decay(base: float, warmup_steps: int, total_steps: int,
                 final_frac: float = 0.1):
    def fn(step):
        s = np.float32(step)
        warm = np.minimum(s / np.float32(max(warmup_steps, 1)),
                          np.float32(1.0))
        prog = np.clip((s - np.float32(warmup_steps))
                       / np.float32(max(total_steps - warmup_steps, 1)),
                       np.float32(0.0), np.float32(1.0))
        cos = np.float32(0.5) * (np.float32(1.0)
                                 + np.cos(np.float32(np.pi) * prog))
        return np.float32(base) * warm * (
            np.float32(final_frac) + np.float32(1 - final_frac) * cos)
    return fn
