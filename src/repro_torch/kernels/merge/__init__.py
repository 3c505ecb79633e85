"""Merge-rank and commit-fold kernels (CUDA) and their plain versions."""
