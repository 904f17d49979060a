"""codeqwen1.5-7b [dense] — Qwen1.5 architecture (hf:Qwen/CodeQwen1.5-7B).

32L d_model=4096 32H (GQA kv=32 -> MHA) d_ff=13440 vocab=92416; QKV bias
(Qwen1.5 style), RMSNorm, SwiGLU, RoPE.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416, head_dim=128,
    norm="rmsnorm", qkv_bias=True, rope_theta=1_000_000.0,
)
