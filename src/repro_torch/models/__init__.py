"""Models of the port: the dense decoder-only transformer, the MoE
decoders (MLA and GQA) and the whisper encoder-decoder, behind
``get_model(cfg)`` (the reference's registry, without the training
entries)."""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

from . import moe, transformer, whisper


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init_params: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable


_FAMILIES = {"dense": transformer, "moe": moe, "encdec": whisper}


def get_model(cfg) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name!r} (family {cfg.family!r}) has no "
                         f"model in the port; ported families: "
                         f"{sorted(_FAMILIES)}")
    mod = _FAMILIES[cfg.family]
    return ModelApi(init_params=mod.init_params, forward=mod.forward,
                    prefill=mod.prefill, decode_step=mod.decode_step)


__all__ = ["ModelApi", "get_model", "moe", "transformer", "whisper"]
