"""Model configuration of the port.

A copy of part of ``repro.configs.base.ModelConfig``: the port imports
nothing of the JAX package, so it keeps its own. The fields, derived
sizes and ``reduced()`` of the dense and MoE families match the reference
exactly, so a reduced config names the same shapes in both packages,
the encoder tower of the ``encdec`` family (whisper), the patch stub of
the ``vlm`` family (qwen2-vl), the recurrence of the ``ssm`` family
(rwkv6) and the ``hybrid`` family (recurrentgemma) included. So do
``param_count`` (which sizes the serving cells' weights) and the input
shapes ``SHAPES`` of the dry run's cells.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "vlm", "moe", "ssm", "hybrid", "encdec"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


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
    mrope: bool = False            # Qwen2-VL multimodal 3-D RoPE
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
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

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head): the
        reference's formula, rwkv6's mixer approximation included."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        embed = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":           # rwkv6
            att = D * D * 4 + D * 64 * 10   # r,k,v,o + lora mixers (approx)
            ffn = D * F + F * D
        elif self.mla is not None:
            m = self.mla
            att = (D * self.num_heads * (m.qk_nope_head_dim
                                         + m.qk_rope_head_dim)
                   + D * (m.kv_lora_rank + m.qk_rope_head_dim)
                   + m.kv_lora_rank * self.num_heads
                   * (m.qk_nope_head_dim + m.v_head_dim)
                   + self.num_heads * m.v_head_dim * D)
            ffn = 0  # counted via moe below
        else:
            att = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            ffn = 3 * D * F
        if self.moe:
            fe = self.moe.d_ff_expert
            ffn = (self.moe.num_experts + self.moe.num_shared_experts) \
                * 3 * D * fe + D * self.moe.num_experts
        if self.family == "hybrid" and self.recurrent:
            W = self.recurrent.lru_width or D
            rec = D * W * 2 + W * D + W * self.recurrent.conv_width + 2 * W
            natt = sum(1 for i in range(L)
                       if self.recurrent.block_pattern[
                           i % len(self.recurrent.block_pattern)] == "attn")
            if L:                                  # averaged per block
                att = att * natt / L + rec * (1 - natt / L)
        blocks = L * (att + ffn + 2 * D)
        if self.encoder and self.family == "encdec":
            enc = self.encoder.num_layers * (4 * D * D + 2 * D * F + 2 * D)
            blocks += enc + L * (4 * D * D)  # cross-attention
        return int(embed + blocks + D)

    def reduced(self) -> ModelConfig:
        """Tiny same-family config for CPU tests: the reference's
        ``reduced()``, field for field (MoE, MLA, recurrence and encoder
        towers cut as it cuts them). Hybrid archs keep one full (rec, rec,
        attn) pattern period, so the windowed attention and its cache are
        exercised: two layers would be a pure recurrence."""
        kw: dict = {}
        if self.moe:
            # the arch's own capacity_factor: drops can occur at this size
            kw["moe"] = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                                  num_shared_experts=self.moe.num_shared_experts
                                  and 1,
                                  capacity_factor=self.moe.capacity_factor)
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                                  qk_rope_head_dim=8, v_head_dim=16)
        if self.recurrent:
            kw["recurrent"] = RecurrentConfig(
                lru_width=64, conv_width=4, window=8,
                block_pattern=self.recurrent.block_pattern)
        if self.encoder:
            kw["encoder"] = EncoderConfig(num_layers=2, seq_len=16)
        return dataclasses.replace(
            self, name=self.name + "-smoke",
            num_layers=3 if self.family == "hybrid" else 2, d_model=64,
            num_heads=4, num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16, d_ff=128, vocab_size=256, **kw)


# --- the input shapes of the dry run's cells (the reference's task spec) -------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
