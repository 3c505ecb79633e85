"""Plain PyTorch version of the segment-sum kernel."""
from __future__ import annotations

import torch


def segment_sum_ref(data: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """[NS, D] f32: the rows of ``data`` [E, D] summed by ``seg_ids`` [E]
    (any order); ids outside [0, NS) are dropped."""
    valid = (seg_ids >= 0) & (seg_ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=torch.float32, device=data.device)
    return out.index_add_(0, seg_ids[valid].long(),
                          data[valid].to(torch.float32))
