"""command-r-plus-104b [dense] — hf:CohereForAI/c4ai-command-r-plus.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000; LayerNorm, no
biases, RoPE theta 7.5e7.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000, head_dim=128,
    norm="layernorm", use_bias=False, rope_theta=75_000_000.0,
)
