"""Models of the port: the dense decoder-only transformer (with the vlm
backbone), the MoE decoders (MLA and GQA), RWKV-6, Griffin (the hybrid
RG-LRU + local attention family) and the whisper encoder-decoder,
behind ``get_model(cfg)`` (the reference's registry): every family has
the reference's ``loss_fn``, the MoE family's with the load-balance
loss."""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

from . import griffin, moe, rwkv6, transformer, whisper


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init_params: Callable
    forward: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    init_decode_state: Callable


_FAMILIES = {"dense": transformer, "vlm": transformer, "moe": moe,
             "ssm": rwkv6, "hybrid": griffin, "encdec": whisper}


def get_model(cfg) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name!r} (family {cfg.family!r}) has no "
                         f"model in the port; ported families: "
                         f"{sorted(_FAMILIES)}")
    mod = _FAMILIES[cfg.family]
    return ModelApi(init_params=mod.init_params, forward=mod.forward,
                    loss_fn=mod.loss_fn,
                    prefill=mod.prefill,
                    decode_step=mod.decode_step,
                    init_decode_state=mod.init_decode_state)


__all__ = ["ModelApi", "get_model", "griffin", "moe", "rwkv6", "transformer",
           "whisper"]
