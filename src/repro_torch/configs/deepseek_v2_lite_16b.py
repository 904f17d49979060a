"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434.

27L d_model=2048 16H vocab=102400; MLA attention (kv_lora_rank=512, rope
head 64), MoE FFN: 2 shared + 64 routed experts top-6, d_ff_expert=1408.
"""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    norm="rmsnorm",
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
)
