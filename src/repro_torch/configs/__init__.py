"""Architecture registry of the port: ``get_config(arch_id)``."""

from . import (codeqwen15_7b, deepseek_v2_lite_16b, olmo_1b, olmoe_1b_7b,
               qwen2_vl_7b, recurrentgemma_9b, rwkv6_7b, whisper_tiny)
from .base import ModelConfig

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (codeqwen15_7b, deepseek_v2_lite_16b, olmo_1b, olmoe_1b_7b,
              qwen2_vl_7b, recurrentgemma_9b, rwkv6_7b, whisper_tiny)}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["REGISTRY", "ModelConfig", "get_config"]
