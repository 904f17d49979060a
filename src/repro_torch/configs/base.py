"""Model configuration of the port.

A copy of part of ``repro.configs.base.ModelConfig``: the port imports
nothing of the JAX package, so it keeps its own. The fields, derived
sizes and ``reduced()`` of the dense family match the reference exactly,
so a reduced config names the same shapes in both packages. The
``encdec`` (whisper) and ``ssm`` (rwkv6) configs carry their widths for
the packing path; their models are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "ssm", "encdec"]


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    """RG-LRU / RWKV-style recurrence parameters."""
    lru_width: int = 0             # 0 -> d_model
    conv_width: int = 4
    window: int = 2048             # local-attention window (hybrid archs)
    block_pattern: tuple[str, ...] = ("rec", "rec", "attn")  # griffin 2:1


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec (whisper) / vision stub (vlm)."""
    num_layers: int = 4
    seq_len: int = 1500            # precomputed frame/patch embeddings (stub)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    norm: Literal["rmsnorm", "layernorm", "nonparametric"] = "rmsnorm"
    use_bias: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    recurrent: RecurrentConfig | None = None
    encoder: EncoderConfig | None = None

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        assert self.num_heads % self.num_kv_heads == 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def reduced(self) -> ModelConfig:
        """Tiny same-family config for CPU tests (the reference's
        ``reduced()`` for the dense family)."""
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16, d_ff=128, vocab_size=256)
