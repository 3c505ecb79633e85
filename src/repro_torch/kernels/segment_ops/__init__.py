"""Sorted segment-sum kernel (CUDA) and its plain version."""
from repro_torch.kernels.segment_ops.ops import segment_sum

__all__ = ["segment_sum"]
