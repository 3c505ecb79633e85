from repro_torch.checkpoint.checkpoint import (CheckpointManager, load_pytree,
                                               load_raw, save_pytree)
