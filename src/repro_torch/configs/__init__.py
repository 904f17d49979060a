"""Architecture registry of the port: ``get_config(arch_id)``, the arch
ids in the reference's order (``ARCH_IDS``), the dry run's input shapes
(``SHAPES``) and the shapes each arch runs (``shapes_for``)."""

from . import (codeqwen15_7b, command_r_35b, command_r_plus_104b,
               deepseek_v2_lite_16b, olmo_1b, olmoe_1b_7b, qwen2_vl_7b,
               recurrentgemma_9b, rwkv6_7b, whisper_tiny)
from .base import SHAPES, InputShape, ModelConfig

REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (codeqwen15_7b, olmo_1b, command_r_35b, command_r_plus_104b,
              rwkv6_7b, recurrentgemma_9b, whisper_tiny, olmoe_1b_7b,
              deepseek_v2_lite_16b, qwen2_vl_7b)}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def shapes_for(arch_id: str) -> tuple[str, ...]:
    """The shapes an arch runs: long_500k only for the sub-quadratic
    families (ssm, hybrid), as in the reference."""
    base = ("train_4k", "prefill_32k", "decode_32k")
    if REGISTRY[arch_id].family in ("ssm", "hybrid"):
        return (*base, "long_500k")
    return base


__all__ = ["ARCH_IDS", "REGISTRY", "SHAPES", "InputShape", "ModelConfig",
           "get_config", "shapes_for"]
