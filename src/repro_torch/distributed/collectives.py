"""Distributed-optimization collectives over a leading worker axis.

The JAX package runs these inside ``shard_map``, one device a worker.
The port keeps its w workers as the leading axis ``[w, ...]`` of one
tensor on one card, the convention of ``core/distributed.py``: a
``psum`` is a sum over axis 0, and a ``psum_scatter`` that sum split
into w slices of the output's feature axis, slice i worker i's.

``compressed_psum``: the int8-quantized gradient all-reduce with error
feedback (EF-SGD): each worker sends its gradient plus last step's
residual, quantized per worker; what quantization dropped is carried to
the next step, so the long-run estimate is unbiased.
``psum_scatter_matmul``: the tensor-parallel second matmul whose
contraction-axis reduction is a reduce-scatter.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: (q int8, f32 scale)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grad: torch.Tensor, residual: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 psum over the workers.  grad, residual [w, ...]
    (f32 residual).  Returns (the mean-reduced gradient f32 [...], each
    worker's new residual [w, ...])."""
    w = grad.shape[0]
    x = grad.to(torch.float32) + residual
    scale = torch.clamp(x.reshape(w, -1).abs().amax(1), min=1e-12) / 127.0
    bscale = scale.reshape((w,) + (1,) * (x.dim() - 1))
    q = torch.clamp(torch.round(x / bscale), -127, 127).to(torch.int8)
    new_residual = x - dequantize_int8(q, bscale)
    # int8 values sum without overflow in int32; the scales are averaged
    total = q.to(torch.int32).sum(0)
    mean = total.to(torch.float32) * (scale.sum() / w) / w
    return mean, new_residual


def psum_scatter_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [w, m, k_shard] @ w [w, k_shard, n] summed over the workers and
    reduce-scattered: [w, m, n / w], worker i holding columns i·n/w ..
    (i + 1)·n/w of the sum."""
    nw, m, _ = x.shape
    total = torch.bmm(x, w).sum(0)  # [m, n]
    n = total.shape[1]
    if n % nw:
        raise ValueError(f"{n} output columns do not split over {nw} "
                         f"workers")
    return total.reshape(m, nw, n // nw).transpose(0, 1)
