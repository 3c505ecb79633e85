from repro_torch.configs.registry import get_arch, list_archs
