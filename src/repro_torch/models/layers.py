"""The layers of the GNN and LM families: initialisers, RMSNorm (with
gemma's ``1 + w``), RoPE, the gated MLP, and the parameter-tree module
both families keep their parameters in.

Parameters are drawn from an explicit ``torch.Generator`` on the
generator's device (the JAX package's ``jax.random`` keys give other
numbers from the same seed; parity tests carry parameters across with
``convert``).  ``maybe_shard`` has no meaning on one card and is not
ported."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, Any]


DRAW = 1 << 26  # elements drawn in f32 at a time


def he_init(gen: torch.Generator, shape: Sequence[int], dtype,
            fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal(0, 2 / fan_in) on the generator's device, fan_in =
    ``shape[0]`` unless given."""
    fan = fan_in if fan_in is not None else shape[0]
    return _normal(gen, shape, (2.0 / max(fan, 1)) ** 0.5, dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype
               ) -> torch.Tensor:
    """Normal(0, 1 / shape[-1]) on the generator's device."""
    return _normal(gen, shape, 1.0 / shape[-1] ** 0.5, dtype)


def _normal(gen: torch.Generator, shape: Sequence[int], std: float,
            dtype) -> torch.Tensor:
    """f32 standard normals times ``std``, cast to ``dtype``.  A leaf of
    more than DRAW elements is drawn a block of leading rows at a time,
    so that a large bf16 leaf never exists whole in f32 (mixtral's
    stacked experts: 45 GB in f32 at 12 layers)."""
    # a host generator draws on the current default device (the GNN's
    # parameter count draws on "meta"), a CUDA one on its card
    device = gen.device if gen.device.type != "cpu" else None
    shape = tuple(shape)

    def draw(sub):
        return (torch.randn(sub, generator=gen, dtype=torch.float32,
                            device=device) * std).to(dtype)
    if not shape or int(np.prod(shape)) <= DRAW:
        return draw(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(DRAW // int(np.prod(shape[1:])), 1)
    for a in range(0, shape[0], rows):
        b = min(a + rows, shape[0])
        out[a:b] = draw((b - a,) + shape[1:])
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis, computed in f32, scaled by ``w`` (by
    ``1 + w`` with ``plus_one``, the gemma convention)."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = w.to(torch.float32)
    if plus_one:
        scale = 1.0 + scale
    return (y * scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Rotary embedding in f32, cast back.  x [..., S, H, Dh]; positions
    [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    # the JAX package's frequencies, from the same numpy expression
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    freqs = torch.from_numpy(np.asarray(freqs, np.float32)).to(x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def gated_mlp(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
              act: str = "silu") -> torch.Tensor:
    """SwiGLU / GeGLU (tanh gelu) with the gate in f32: w_in [d, 2*ff]
    packs (gate, up)."""
    h = x @ w_in
    gate, up = h.chunk(2, dim=-1)
    g = gate.to(torch.float32)
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (g * up.to(torch.float32)).to(x.dtype) @ w_out


class ParamTree(nn.Module):
    """A nested dict of parameters as a module: ``tree["w1"]``, and
    dotted names (``layers.phi_e.w1``) in ``named_parameters``."""

    def __init__(self, tree: Params):
        super().__init__()
        self._names = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v))
            else:
                self.add_module(k, ParamTree(v))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def items(self):
        return [(k, self[k]) for k in self._names]


def layer_slice(p: ParamTree, i: int) -> Params:
    """Layer ``i``'s slice of stacked ``[L, ...]`` layer parameters."""
    return {k: layer_slice(v, i) if isinstance(v, ParamTree) else v[i]
            for k, v in p.items()}
