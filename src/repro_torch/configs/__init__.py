from repro_torch.configs.base import (ArchSpec, CFConfig, GNNConfig, LMConfig,
                                MoEConfig, RecsysConfig, ShapeSpec, get_arch,
                                list_archs, register)

__all__ = [
    "ArchSpec", "CFConfig", "GNNConfig", "LMConfig", "MoEConfig",
    "RecsysConfig", "ShapeSpec", "get_arch", "list_archs", "register",
]
