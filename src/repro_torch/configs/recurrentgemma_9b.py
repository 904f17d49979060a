"""recurrentgemma-9b [hybrid] — Griffin (arXiv:2402.19427).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; RG-LRU recurrent
blocks + local sliding-window attention, pattern 2 recurrent : 1 attention.
"""

from .base import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    norm="rmsnorm",
    recurrent=RecurrentConfig(lru_width=4096, conv_width=4, window=2048,
                              block_pattern=("rec", "rec", "attn")),
)
