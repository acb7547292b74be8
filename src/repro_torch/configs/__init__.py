from .base import (
    ARCH_IDS,
    LONG_CONTEXT_ARCHS,
    SHAPES,
    InputShape,
    ModelConfig,
    get,
    get_smoke,
    supported_cells,
)

__all__ = [
    "ARCH_IDS", "LONG_CONTEXT_ARCHS", "SHAPES", "InputShape", "ModelConfig",
    "get", "get_smoke", "supported_cells",
]
