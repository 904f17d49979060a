"""rwkv6-7b [ssm] — RWKV-6 "Finch" (arXiv:2404.05892), attention-free.

32L d_model=4096 d_ff=14336 vocab=65536; data-dependent decay (LoRA-projected
per-channel w), token-shift mixing, WKV linear recurrence. head_dim=64.
"""

from .base import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536, head_dim=64,
    norm="layernorm",
    recurrent=RecurrentConfig(lru_width=4096, conv_width=0, window=0,
                              block_pattern=("rec",)),
)
