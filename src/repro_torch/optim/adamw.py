"""AdamW (decoupled weight decay) over a dict of named parameters.

The JAX package's ``adamw_update`` as it is: global-norm clipping (at 1.0
by default; the norm is reported also when clipping is off), bias-corrected
moments with b1 0.9 and b2 0.95, eps added after the square root, decay on
leaves with ndim >= 2 unless a mask says otherwise, f32 moments whatever
the parameter dtype, and an int step counter.  ``torch.optim.AdamW`` is a
different function (no clipping, other defaults) and is not used.

Unlike the JAX package's pure update, parameters and moments are updated
in place (no second copy of either on the device), and the clipped
gradients and the update's temporaries exist only a slice of at most
``CHUNK`` elements at a time: the full-width two-tower model holds ~50 GB
of parameters, gradients and moments on an 80 GB card, and whole-leaf
temporaries of its 10M-row table (~10 GB each) would not fit beside them.
The slices change no element's arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]

CHUNK = 1 << 24  # elements of a leaf updated at a time


@dataclasses.dataclass
class AdamWState:
    step: int  # updates taken
    mu: Tensors  # first moments (f32), by parameter name
    nu: Tensors  # second moments (f32), by parameter name


def _named(params) -> Tensors:
    """A module's parameters by dotted name, or a dict as it is."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> AdamWState:
    """Zero moments for a module's parameters (or a dict of tensors)."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in _named(params).items()}
    return AdamWState(0, zeros, {k: v.clone() for k, v in zeros.items()})


def _norm_and_scale(grads: Tensors, max_norm: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global f32 norm of ``grads``, the factor that clips it to
    ``max_norm``)."""
    norm = torch.sqrt(sum(g.to(torch.float32).square().sum()
                          for g in grads.values()))
    return norm, torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                             max=1.0)


def _clip(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Returns (clipped grads, pre-clip global norm)."""
    norm, scale = _norm_and_scale(grads, max_norm)
    return {k: _clip(g, scale) for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(params, grads: Tensors, state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 decay_mask: Optional[Callable[[str], bool]] = None,
                 max_grad_norm: float = 1.0) -> torch.Tensor:
    """One AdamW step, in place on ``params`` (a module or a dict of
    tensors) and ``state``; ``grads`` by the same names.  ``lr`` is a
    number or a schedule value.  ``decay_mask(name) -> bool`` selects the
    leaves that receive weight decay (default: ndim >= 2).  Returns the
    pre-clip global gradient norm."""
    params = _named(params)
    # each slice's gradient is clipped as clip_by_global_norm clips it
    gnorm, scale = _norm_and_scale(grads, max_grad_norm)
    state.step += 1
    t = np.float32(state.step)
    b1t = float(np.float32(1.0) - np.power(np.float32(b1), t))
    b2t = float(np.float32(1.0) - np.power(np.float32(b2), t))
    lr = float(np.float32(lr))
    for name, p in params.items():
        apply_wd = decay_mask(name) if decay_mask is not None \
            else p.ndim >= 2
        g, mu, nu = grads[name], state.mu[name], state.nu[name]
        if p.is_contiguous():
            g = g.reshape(-1)
            views = [(p.view(-1)[a:a + CHUNK], g[a:a + CHUNK],
                      mu.view(-1)[a:a + CHUNK], nu.view(-1)[a:a + CHUNK])
                     for a in range(0, p.numel(), CHUNK)]
        else:
            views = [(p, g, mu, nu)]
        for pv, gv, mv, nv in views:
            g32 = (_clip(gv, scale) if max_grad_norm > 0
                   else gv).to(torch.float32)
            m = mv.mul_(b1).add_((1 - b1) * g32)
            v = nv.mul_(b2).add_((1 - b2) * g32.square())
            upd = (m / b1t) / (torch.sqrt(v / b2t) + eps)
            if apply_wd and weight_decay > 0:
                upd = upd + weight_decay * pv.to(torch.float32)
            pv.copy_((pv.to(torch.float32) - lr * upd).to(pv.dtype))
    return gnorm
