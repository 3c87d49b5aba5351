from repro_torch.configs.base import (
    FLConfig,
    ModelConfig,
    get_config,
    list_configs,
    load_all,
    register,
)

__all__ = [
    "FLConfig",
    "ModelConfig",
    "get_config",
    "list_configs",
    "load_all",
    "register",
]
