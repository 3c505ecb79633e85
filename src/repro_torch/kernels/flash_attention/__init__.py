"""Flash-attention kernel (CUDA) and its plain version."""
from repro_torch.kernels.flash_attention.ops import flash_attention, mha

__all__ = ["flash_attention", "mha"]
