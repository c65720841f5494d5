"""Architecture registry of the port: ``arch id -> ModelConfig``."""
from __future__ import annotations

from typing import Callable, Dict

from .config import ModelConfig
from .configs import mixtral_8x7b
from .configs.base import reduce_config

REGISTRY: Dict[str, Callable[[], ModelConfig]] = {
    "mixtral-8x7b": mixtral_8x7b.config,
}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    cfg = REGISTRY[name]()
    return reduce_config(cfg) if reduced else cfg
