from repro_torch.configs.base import (
    SHAPE_CELLS,
    ModelConfig,
    ShapeCell,
    get_config,
    list_archs,
    register,
)

__all__ = [
    "SHAPE_CELLS",
    "ModelConfig",
    "ShapeCell",
    "get_config",
    "list_archs",
    "register",
]
