"""Multi-region signed membership kernel (CUDA) and its plain version."""
