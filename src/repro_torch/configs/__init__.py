from repro_torch.configs.registry import ALL_ARCHS, get_config, list_archs

__all__ = ["ALL_ARCHS", "get_config", "list_archs"]
