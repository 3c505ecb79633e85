"""Sorted segment sum: the message aggregation of the GNN layers.

Replaces the TPU kernel ``src/repro/kernels/segment_ops/segment_ops.py``
(``segment_sum_kernel`` / ``_segment_sum_call``, reached through
``ops.segment_sum``).  The CUDA kernel is ``csrc/segment_sum.cu``: tiles of
32 sorted rows summed in row order, segments whole inside a tile written
straight out, the runs that cross tile boundaries summed by a fixed-order
tree of groups of 16 partials (one launch a level), in f32 and without
atomics, so two calls on one input give the same bits; it is bound by the
bytes it moves (see the source note there).
``ref.segment_sum_ref`` is its plain version.

On ``meta`` tensors (the dry run) a call takes the kernel's path up to
the launch: the sort of unsorted ids, the cast, the scratch
(:func:`scratch_words`) and the output, empty; then it adds
:func:`kernel_ops` to ``kernels.META_OPS``.

The op carries a gradient (:class:`_SegmentSum`): the backward of a
segment sum is the gather ``grad_out[seg]`` (0 for dropped rows), plain
PyTorch indexing, as the JAX package has no backward kernel for it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, count_launch, count_meta_ops
from repro_torch.kernels.segment_ops.ref import segment_sum_ref


def segment_sum(data: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int, is_sorted: bool = False
                ) -> torch.Tensor:
    """[NS, D] f32: the rows of ``data`` [E, D] summed by segment id;
    empty segments are 0 and ids outside [0, NS) are dropped (``NS`` is
    the padding sentinel).  ``is_sorted`` promises nondecreasing ids;
    otherwise a stable sort runs here, outside the kernel.  A CPU tensor
    takes the plain version, a CUDA tensor the kernel, a meta tensor the
    kernel's shapes and operation count."""
    if data.dim() != 2 or seg_ids.dim() != 1 \
            or seg_ids.shape[0] != data.shape[0]:
        raise ValueError(f"segment_sum takes data [E, D] and ids [E], got "
                         f"{tuple(data.shape)} and {tuple(seg_ids.shape)}")
    return _SegmentSum.apply(data, seg_ids, int(num_segments),
                             bool(is_sorted))


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg_ids, num_segments, is_sorted):
        ctx.save_for_backward(seg_ids)
        ctx.num_segments = num_segments
        ctx.dtype = data.dtype
        if not (data.is_cuda or data.is_meta):
            return segment_sum_ref(data, seg_ids, num_segments)
        seg = seg_ids.to(torch.int32)
        if not is_sorted:
            seg, order = torch.sort(seg, stable=True)
            data = data[order]
        return _launch(data, seg, num_segments)

    @staticmethod
    def backward(ctx, grad):
        (seg_ids,) = ctx.saved_tensors
        ns = ctx.num_segments
        valid = (seg_ids >= 0) & (seg_ids < ns)
        if ns == 0:
            g = torch.zeros((seg_ids.shape[0],) + tuple(grad.shape[1:]),
                            dtype=grad.dtype, device=grad.device)
        else:
            g = grad[seg_ids.clamp(0, ns - 1).long()]
            g = torch.where(valid[:, None], g, torch.zeros_like(g))
        return g.to(ctx.dtype), None, None, None


def kernel_launches(E: int) -> int:
    """CUDA launches of one call over ``E`` rows: the tiles, then one per
    level of the partials' tree (the count depends on E alone)."""
    return _build.lib("segment_sum").repro_segment_sum_launches(E)


def kernel_ops(E: int, D: int) -> int:
    """Operations of one call over ``E`` rows of width ``D``: an add an
    element."""
    return E * D


def scratch_words(E: int, D: int) -> int:
    """4-byte words of scratch a call over E rows of width D takes: D
    floats and an int2 a slot, two slots a tile of 32 rows (at least
    one tile) and two a group of 16 of those (``csrc/segment_sum.cu``'s
    ``repro_segment_sum_scratch``, which the card's check holds equal)."""
    m0 = 2 * max(-(-E // 32), 1)
    m1 = 2 * -(-m0 // 16)
    return (m0 + m1) * (D + 2)


def _launch(data: torch.Tensor, seg: torch.Tensor, num_segments: int
            ) -> torch.Tensor:
    if data.dtype not in (torch.float32, torch.float16):
        data = data.to(torch.float32)
    data, seg = data.contiguous(), seg.contiguous()
    meta = data.is_meta
    if meta:
        if not seg.is_meta:
            raise ValueError("mixed meta and other operands to the "
                             "segment_sum kernel")
    else:
        _build.require_cuda(data, seg)
    E, D = data.shape
    if num_segments == 0 or D == 0:  # nothing to launch
        return torch.zeros((num_segments, D), dtype=torch.float32,
                           device=data.device)
    if meta:
        scratch = torch.empty(scratch_words(E, D), dtype=torch.int32,
                              device=data.device)
        out = torch.empty((num_segments, D), dtype=torch.float32,
                          device=data.device)
        count_meta_ops("segment_sum", kernel_ops(E, D))
        return out
    lib = _build.lib("segment_sum")
    scratch = torch.empty(lib.repro_segment_sum_scratch(E, D),
                          dtype=torch.int32, device=data.device)
    out = torch.empty((num_segments, D), dtype=torch.float32,
                      device=data.device)
    rc = lib.repro_segment_sum(
        _build.ptr(data), int(data.dtype == torch.float16), _build.ptr(seg),
        E, D, num_segments, _build.ptr(scratch), _build.ptr(out),
        _build.stream_of(data))
    _build.check("segment_sum", rc)
    count_launch("segment_sum")
    return out
