from .config import (
    ModelConfig,
    EnvConfig,
    TrainConfig,
    HAMTConfig,
    get_preset,
    PRESETS,
)

__all__ = [
    "ModelConfig",
    "EnvConfig",
    "TrainConfig",
    "HAMTConfig",
    "get_preset",
    "PRESETS",
]
