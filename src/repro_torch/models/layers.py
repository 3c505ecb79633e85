"""The layers the GNN family needs: He initialisation and RMSNorm.

Parameters are drawn on the host from an explicit ``torch.Generator``
(the JAX package's ``jax.random`` keys give other numbers from the same
seed; parity tests carry parameters across with ``convert``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def he_init(gen: torch.Generator, shape: Sequence[int], dtype,
            fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal(0, 2 / fan_in) on the host, fan_in = ``shape[0]`` unless
    given."""
    fan = fan_in if fan_in is not None else shape[0]
    std = (2.0 / max(fan, 1)) ** 0.5
    return (torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
            * std).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm over the last axis, computed in f32, scaled by ``w``."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32)).to(x.dtype)
