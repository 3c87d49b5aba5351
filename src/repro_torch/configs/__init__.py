from repro_torch.configs.base import (
    ASSIGNED_ARCHS,
    INPUT_SHAPES,
    FLConfig,
    InputShape,
    ModelConfig,
    get_config,
    list_configs,
    load_all,
    register,
)

__all__ = [
    "ASSIGNED_ARCHS",
    "INPUT_SHAPES",
    "FLConfig",
    "InputShape",
    "ModelConfig",
    "get_config",
    "list_configs",
    "load_all",
    "register",
]
