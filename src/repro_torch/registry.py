"""Architecture registry of the port: ``arch id -> ModelConfig``."""
from __future__ import annotations

from typing import Callable, Dict

from .config import ModelConfig
from .configs import (deepseek_moe_16b, gemma3_1b, gemma3_27b,
                      llama3_2_3b, llama4_scout_17b_a16e, mixtral_8x7b,
                      mixtral_8x22b, qwen2_7b, qwen3_moe_30b_a3b)
from .configs.base import reduce_config

REGISTRY: Dict[str, Callable[[], ModelConfig]] = {
    "mixtral-8x7b": mixtral_8x7b.config,
    "llama3.2-3b": llama3_2_3b.config,
    "deepseek-moe-16b": deepseek_moe_16b.config,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.config,
    "gemma3-1b": gemma3_1b.config,
    "gemma3-27b": gemma3_27b.config,
    "qwen2-7b": qwen2_7b.config,
    "mixtral-8x22b": mixtral_8x22b.config,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e.config,
}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    cfg = REGISTRY[name]()
    return reduce_config(cfg) if reduced else cfg
