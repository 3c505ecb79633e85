"""Fused BiGJoin extension-step kernel (CUDA) and its plain version."""
